#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero, with no result line),
in order. Every "device ms" is the profiler's kernel time in a trace that
recorded every launch made; where no trace does, the kernels line says
"events" and the time is that of back-to-back calls between CUDA events:

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of the CUDA kernels of all 14 functions (NMS K3, bucket reduce K1,
   pairwise IoU K2, quant8 reduce K4, row quantize/dequantize K5a/K5b,
   grouped reduce K6, quant4 reduce K7, masked sum K8, flash attention K9,
   SSD chunk scan K10, per-leaf FedAvg K11, block quantize/dequantize
   K12a/K12b) from ``src/repro_torch/kernels/csrc`` and its time.
2. NMS kernel vs plain: the CUDA keep-mask kernel against the plain
   PyTorch scan, both on the card, over seven case kinds (one with boxes
   whose IoU lands exactly on the threshold) at (B, N) in (1, 1), (8, 16)
   (served), (3, 33) (a word edge), (8, 64) (eval), (64, 100), (4, 1024)
   (the bitmask kernel's largest) and (2, 2048) (the scan kernel's). Keep
   masks must be bitwise equal (tolerance: none), the whole NMS and the
   keep mask alone. Median times over 20 launches, CUDA events (the plain
   scan at N 1024 and 2048: 3 launches after one warm-up).
3. Serving at full width: fedyolov3 (5 stages, widths 64..1024, 13.3 M
   params, random weights from seed 0) at 416x416, serve_batch 8, 16
   detections per image, behind ``InferenceService``; 8 concurrent
   ``InferenceClient``s send 128 requests each (64 distinct scenes).
   Checks: nothing dropped, every RESULT carries version 1, detections
   were served, the NMS kernel launched once per served batch, a lone
   request's RESULT equals the direct program output bitwise (the
   padded-batch pin), slot 0 alone equals slot 0 in a full batch, decode
   with the CUDA NMS equals decode with the plain NMS, and the card's
   forward agrees with the host's (rtol 1e-4 / atol 1e-5). Then a profile
   of the detection program (exactly one ``nms_bitmask_kernel`` launch a
   batch), and the kernel's time at the served shape on the served inputs
   beside its bound and the card's launch floor (the device time of a
   one-element kernel: the real bound of the launch-bound K2 and K3), with
   the share of the floor reached.
4. K1 and K2 vs plain, bitwise (tolerance: none): the bucket reduce at the
   training path's (3, 13,312,864) with fedyolov3's bucket ids and mask
   [1, 0, 1], at the reference's random-id cases (4, 3000, 3), (3, 1024, 5),
   (2, 77, 2) with and without a mask, and at (64, 1<<20, 8); the pairwise
   IoU at (B, N, M) in (12, 64, 3), (1, 1, 1), (8, 128, 128), (2, 1000,
   1000), (4, 300, 7), IoU and GIoU, random and degenerate boxes. Median
   kernel ms over 20 launches (CUDA events), device ms (profiler), plain
   ms, and the bound.
5. Federated training at full width. (a) One masked eq6 round on the card
   and the same round on the host (``device="cpu"``) from one initial
   state and one batch (img 64, 3 clients, batch 2, sgd lr 1e-3): round
   loss and packed params agree at rtol 1e-4 / atol 1e-5, gap printed.
   (b) The launcher's path (``repro_torch.launch.train``): 3 clients,
   masked participation with a budget of 2, fairness 3, eq6 topn 4, sgd
   lr 1e-3, E 1, batch 8 per client, img 416, 10 rounds, mAP at rounds 0,
   5 and 9 on a 4-image-per-client holdout, COS checkpoints every 5
   rounds. Checks: finite losses, K1 launched once per round, K2 once per
   eval, K3 at least once per eval, COS rounds [0, 5], every mAP in
   [0, 1], some round with a client masked out (the scheduler's fairness
   floor may add a third participant to the budget of 2); then the trained
   model, published to a ``ModelSlot``, serves requests through
   ``InferenceService`` at the trained version with nothing dropped.
   Prints ms per round split into local training and aggregation (CUDA
   events), a profile of one round, and the loss and mAP trajectory.
6. K4, K6, K7 and K8 vs plain, bitwise (tolerance: none): quant8 (K4) and
   quant4 (K7, nearest and stochastic under two keys) at the quant8/quant4
   round's (3, 13,312,864), the grouped reduce (K6) at hier's (4,
   13,312,864) with G = 2, the masked sum (K8) at secure's padded (3,
   13,313,024) with participation [1, 0, 1]; and ragged cases: N not a
   multiple of 1024 or of 4, C above 8, C = 1, partial and empty
   participation, rows at 0 and near 2^32; for K4/K7 also the whole-tile
   kernel's edges (C = 17, N one whole persistent grid stride, a partial
   last stride), blocks 4 and 4096 at C = 1, rows 4 bytes off a 16-byte
   boundary, and rows whose values span 2^-130 to 2^125 with ties. Kernel
   ms (CUDA events), device ms (profiler), plain ms, the bound, for K4/K7
   also device ms with the L2 flushed before each call, and for K6
   ``torch.bmm`` on the same operands as the library yardstick.
7. The uplink modes at full width. (a) One realistic buffer on the card
   (the round-0 dispatch plus one local sgd step per client, 4 clients,
   img 64): ``aggregate`` on the card (kernels) equals the same call on the
   host (plain versions) bitwise for quant8, quant4 (stochastic), secure
   (int8, masked), topk_ef (frac 0.1, quant4) and hier (C = 4, G = 2, over
   dense), all with a client masked out; fedavgm, fedadam and trimmed_mean
   at rtol 1e-6 / atol 1e-8 (their reductions and server steps may round
   once differently on the card); secure with masks equals secure without,
   and topk_ef's split recomposes its compensated delta, both bitwise on
   the card. (b) The launcher's path per mode (quant8, quant4, secure,
   topk_ef, hier over eq6 with 4 clients in groups of 2): img 416, batch 8,
   sgd lr 1e-3, masked participation with a budget of 2, 3 rounds each;
   finite losses, and per round one launch of K5a and none of K4 (quant8:
   the launcher's 1 x 1 client mesh takes the gathered int8 transport), K7
   (quant4), K8 (secure), K1 (topk_ef), K6 and K1 (hier); K5b in no run.
   Prints ms per round with the aggregation timed alone, and the peak
   device memory. Then K4's path: an ``FLServer`` quant8 run without a
   mesh, 3 rounds, one K4 launch per round and no K5a or K5b.
8. K9 and K10 vs plain (rtol = atol = 2e-4 in float32, 3e-2 in bfloat16,
   the reference's own tolerances): flash attention at the qwen3 prefill's
   (4, 16, 1024, 128) with 8 kv heads, causal, in float32 and bfloat16,
   then windows 64 and 128, causal off, H = Hkv, hd 64, S = 128 and S = 64
   (half of one 128-row query tile), S = 192 (a ragged second tile) in
   float32 and bfloat16, windows of 100 and 130 that cross key-tile and
   query-tile borders, a window without causality; the SSD chunk scan's
   four outputs at the mamba2 prefill's (B 4, S 1024, H 64, P 64, N 128,
   chunk 128), the reference test's shapes (chunks 8, 16, 32), the main
   shape with bfloat16 inputs, 12 heads, chunk 64, 17 heads (a ragged last
   head group), P = 128 (two 64-column head blocks) and a bfloat16 case
   with P = 100 and N = 36; then phase 15's prefill shapes: K9 at zamba2's
   (4, 32, 1024, 80) over 32 kv heads, gemma3's (4, 32, 1536, 128) over 16
   with a window of 1024, llava's (2, 64, 3968, 128) over 8, grok's (4, 48,
   1024, 128) and minitron's (4, 32, 1024, 128) over 8; K10 at zamba2's
   (B 4, S 1024, H 80, P 64, N 64, chunk 128). First the count of tensor-core instructions
   (HMMA/HGMMA) in each K9/K10 kernel's SASS, by ``cuobjdump`` (else the
   ``mma`` instructions of the sources); a kernel with none fails.
   Kernel ms (CUDA events), device ms (profiler), plain ms, two bounds (the
   tensor cores' through the 3xTF32 split, and the FP32 units', the bound of
   the kernels' earlier scalar designs), and for K9
   ``scaled_dot_product_attention`` on the same float32 operands as the
   library yardstick.
9. LM serving at full width through the launcher
   (``repro_torch.launch.serve``): qwen3-1.7b and mamba2-1.3b, random
   float32 weights from seed 0, ``--batch 4 --prompt-len 1024
   --new-tokens 32``. Checks: K9 launched 28 times (qwen3) and K10 48 times
   (mamba2) in the launcher's run, exactly one prefill's worth, and 0 times
   in a decode step; the kernel path's last-token prefill logits equal the
   plain path's (``attention_impl`` / ``ssm_impl = "ref"``, same weights,
   same card) at rtol = atol = 5e-4, the first decode step's at 5e-3; the
   kernel path, teacher-forced on the plain path's 32 greedy tokens, picks
   the same token at every step whose top-2 margin exceeds twice the
   logit gap. Prints prefill ms, decode ms per token, tokens/s, peak device
   memory, and a profiled prefill's and decode step's device time split
   into K9 / K10, the cuBLAS products and the rest, with the idle share.
10. LM training and the compression demo at full width. (a) K11 against its
   plain version, bitwise (tolerance: none), at C in (1, 2, 3, 8) and N in
   (1, 1023, 1025, 4,194,305), f32 and bf16, full, alternating and all-zero
   masks; its times at the main path's largest leaf (C 2, 352,321,536
   elements) beside the bound, the plain version and ``torch.mv``. (b)
   Gradients through K9 and K10: a one-layer qwen3-1.7b and mamba2-1.3b at
   full width, batch 1 x 1024, f32, kernel branch against plain branch:
   loss rtol 1e-4, gradients rtol 5e-3 / atol 5e-4 (the reference's pins),
   2 launches (the forward and its checkpointed recompute). (c) One masked
   adamw eq6 round of the reduced qwen3 at seq 128 on the card and on the
   host from one state, at the CPU tests' bounds. (d) The launcher's LM path
   (``repro_torch.launch.train --task lm --full-size --clients 2 --rounds 3
   --batch 1 --seq 1024``) for qwen3-1.7b and mamba2-1.3b, one after the
   other: finite losses, K9 / K10 launched 2 per layer per local step, K1
   once per round, peak device memory under 75 GiB; ms per round and the
   eq6 aggregation alone (CUDA events), a profiled round's idle share.
   (e) The demo's tail (``examples.compression_demo.report``) on qwen3's
   trained state: Eq. 6 scores and uploads, one K1 launch, ``fedavg_tree``
   with one K11 launch per leaf, bitwise equal to its plain version.
11. The row and block quantizers, compact participation and fedsgd. (a)
   K5a/K5b against their plain versions, bitwise (tolerance: none), at the
   quant8 round's (3, 13,312,864) with block 1024, at N off the block and
   off 4, C = 1, 9 and 17, blocks 64, 128 and 4096, an all-zero block (the
   1e-12 floor), rows whose x/s sits on .5 ties (half to even) and at
   +-127 s (blocks 256 and 1024), the whole-tile kernel's edges (C = 17,
   the smallest launch it takes and one unit less, N one whole persistent
   grid stride, a partial last stride and block), rows 4
   bytes off a 16-byte boundary (the generic kernel) and rows whose values
   span 2^-130 to 2^125 with ties, float32 and bfloat16 outputs; K12a and
   the single-leaf decode (K5b at C = 1) on row 0 of every case;
   K12a/K12b through ``ops.quantize_tree`` / ``dequantize_tree`` over
   fedyolov3's whole tree, K12a one launch per leaf, K12b one launch for
   the tree, every leaf bitwise; K12b over a
   synthetic tree of more leaves than its launch table holds (f32 and bf16,
   leaves of 0, 1, 3, 1023, 1025 elements and more, a q 1 byte off 16),
   one launch per 64 leaves. Kernel ms (CUDA events), device ms (profiler:
   K5a by its whole-tile kernel's name, the tree by every quantize launch
   and by ``treedequant_kernel``, all required to come from a full trace),
   for K5a also with the L2 flushed before each call, plain ms and the
   bound. (b) quant8 ``aggregate`` on phase
   7a's buffer with a client masked out: the launcher's 1 x 1 mesh on a
   1-rank NCCL group (K5a, the int8 and scale all-gathers, the
   decode-reduce) equals meshless K4 and the host's plain path bitwise;
   both times. (c) The launcher at full width with ``--participation
   compact --clients 3 --max-participants 2``, ``--agg quant8`` and
   ``--agg eq6``, img 416, batch 8, sgd 1e-3, 3 rounds each: finite
   losses, exactly 2 local steps a round, K5a once per quant8 round, K4
   and K5b never, K1 once per eq6 round; ms per round, aggregation alone, peak
   memory. (d) fedsgd: ``FLServer`` with one shared fedyolov3 copy, 3
   clients' batches of 8 at 416 as one batch of 24, 3 rounds: finite
   losses, peak device memory under 75 GiB, ms per round; and one round at
   img 64 on the card against the host at rtol 1e-4 / atol 1e-5.
12. The async control plane (``core/async_engine.py``). (a) Buffered eq6 at
   fedyolov3's full width (img 416, sgd 1e-3, batch 8, C 3, a flush every 2
   landings, alpha 0.5, max_staleness 2, uplink spread 0.5, seed 4): a
   full-buffer flush equals the sync round on the card bitwise (params,
   opt, agg state, loss); 6 flushes with a staleness-1 landing and a drop,
   every row in flight bitwise across each flush, K1 once a flush (the
   counter, and a profile of 2 more flushes); the launcher's ``--mode
   async`` for 3 flushes, K1 once each. (b) Streaming dense, C 16, a flush
   every 8, max_staleness 4, batch (16, 1, 8, 416, 416, 3), against its
   buffered twin from one seed: ring row 0 is make_state's row 0 bitwise,
   participants, staleness and drops identical, the global within 1e-5 of
   its largest magnitude (``tests/test_stream_async.py``'s tolerance); K1
   never in the streaming flushes, once a twin flush. (c) The arrival
   engine on the reduced qwen3 (the wire's default run meta) under the
   dense and quant8 codecs: a recorded dispatch/land sequence (5 flushes,
   a drop) replays through a fresh engine bitwise (dense) or within 1e-5
   (quant8), K1 once a landing flush in both, and ``export_state`` /
   ``import_state`` round-trips bitwise. Prints ms per flush (CUDA events)
   and peak device memory of each engine.
13. The socket wire at full width (``core/transport/{server,harness}.py``,
   ``launch/worker.py``, ``checkpoint/durable.py``). qwen3-1.7b at its
   published widths with its depth cut to 2 layers (N = 411,838,976: a
   DISPATCH frame carries the dense f32 row and a frame is capped at
   2^31 bytes), 4 clients in 2 worker processes on the card, a flush every
   2 landings, batch 1 x 128. (a) The quant8 socket run, 2 flushes: no
   deadline hit, K1 once a flush in the server, the recorded schedule
   replayed on the card to the run's global within 1e-5; prints the dispatch frame's bytes against
   MAX_FRAME, landings, drops, bytes up and down, seconds, the landing
   loop's median host ms per landing by step (d2h, decode, h2d, land, the
   flush's land) and per dispatch, the server's peak device memory; then
   K1 at a flush's shape (4, N) with the run's bucket ids, bitwise against
   its plain version, its device ms beside its bound. (b) The dense socket
   run with a snapshot every 2 landings, killed after 3 (``kill@3``),
   restored on the same port, 2 flushes: recovered, crashed, one
   recovery, K1 once a flush and once a flush its recovery replays, the
   WAL's schedule replayed to the recovered run's global bitwise; prints
   the run's readings as (a) does, the snapshot's bytes and seconds and
   the recovery's
   seconds and replayed events. (c) The launcher at the reduced size:
   ``--transport socket --wire-codec quant8 --record-schedule``, its
   ``--replay-schedule``, a ``--durable-dir`` run with ``--fault-plan
   kill@5``, and ``--restore``; each returns the reference's JSON keys.
14. The multi-task platform (``core/{task_manager,client,secure_agg}.py``,
   ``FLServer(clock=)``, ``examples/{multi_task_platform,quickstart}.py``).
   (a) ``multi_task_platform.run_platform`` at full width: qwen3-1.7b at
   its published widths cut to 2 layers (eq6 top-2, adamw 3e-3, C 3,
   batch 2 x 128, 8 rounds) beside fedyolov3 (dense, sgd 1e-3, C 2, batch
   8 of the per-step 416x416 scenes, 6 rounds) under one Task Manager, 3
   ``FLClient``s with 2 reconnects each: 8 fair-share passes, both tasks
   done, K1 once a round, both ``render_task`` views and ``export_json``
   feeds (parsed back), ``explorer.monitor()``, the secure sidebar's gap to
   the plain mean over the LM's 3 client trees at most 1e-3, ms per round
   per task (CUDA events), peak memory at most 45 GiB; then K1 at both
   tasks' shapes, (2, 13,312,864) and (3, 411,838,976) with their own
   bucket ids, bitwise against its plain version. (b) One ``SimClock``
   shared by a sync fedyolov3 server (3 rounds) and an async qwen3 server
   (buffered eq6, C 3, a flush every 2 landings, 3 flushes) under
   ``TaskManager(clock=).run_to_completion``: each step runs the task of
   least ``(next_time(), task_id)``, the clock never goes back, a sync
   round moves the clock and its load model by the same span, the flushes'
   ``sim_time`` is sorted, K1 once a round or flush, an untimed task is
   refused. (c) 14a's detector behind ``InferenceService``: 16 requests,
   none dropped, K3 once a served batch, ``monitor.render_serving``. (d)
   The quickstart at the reference's defaults with ``--rounds 5``: its
   loss falls, K1 once a round.
15. The other LM families served at full width through the launcher
   (``repro_torch.launch.serve``, ``models/{serving,moe}.py``), random f32
   weights from seed 0 drawn on the card, float32 caches, 16 new tokens:
   granite-moe-1b-a400m (GShard, 32 experts top 8, groups of 512) and
   minitron-8b (untied 256k head) whole, batch 4 x 1024; grok-1-314b cut to
   2 layers, 4 x 1024; gemma3-27b cut to 14 layers (2 period groups and a
   2-layer tail), 4 x 1536 (512 past its 1024-token window); zamba2-2.7b
   whole (54 Mamba2 layers, 6 applications of the shared block), 4 x
   1024; llava-next-34b cut to 6 layers, 2 x 1088 behind 2880 image
   tokens (64 q heads, 8 of them dead padding). Checks: K9 launched 24, 2,
   14, 6, 6 and 32 times and K10 54 times (zamba2) in the launcher's run,
   one prefill's worth, and 0 times in decode; the kernel path's prefill
   logits equal the plain path's at 5e-4 and the first decode step's at
   5e-3; the kernel path's greedy decode, teacher-forced against a full
   forward over the sequence it generated, within 5e-3 (the check a ring
   cache in the wrong slot order fails) and the same token wherever the
   top-2 margin exceeds twice the gap (MoE: the tokens only, since GShard's
   capacity depends on the routing group); peak device memory at most 75
   GiB. Prints prefill ms, decode ms per token and tokens/s.
16. The other LM families trained at full width through the launcher
   (``repro_torch.launch.train.train_lm``, ``models/{transformer,moe}.py``):
   random f32 weights from seed 0, eq6, C = 2, 2 rounds of one local step
   at batch 1: granite-moe-1b-a400m (adamw, 1 x 1024) and hubert-xlarge
   (adamw, 1 x 1024 frames) whole, zamba2-2.7b cut to 18 layers (2 groups,
   the shared block applied twice; adamw, 1 x 1024), llava-next-34b cut to
   1 layer (adamw, 1 x (2880 image tokens + 1088)), gemma3-27b cut to a
   tail of 2 windowed layers (sgd 0.05, 1 x 1536, 512 past its window).
   (a) Finite losses, K9 launched 48, 0, 4, 2 and 4 times and K10 36 times
   (zamba2) a local step (the forward and the checkpoint's recompute), K1
   once a round, peak device memory at most 75 GiB; ms a round and the
   eq6 aggregation alone (CUDA events). (b) One masked adamw eq6 round of
   each new family at the reduced size, seq 128 (MoE gshard and sort,
   gemma3 at 8 layers, zamba2 at 4, llava with dead heads, hubert) on the
   card against the host from one state, at phase 10c's bounds; MoE's
   first-step expert choices compared first (at most 1 in 1000 may flip,
   and the round is held whole only where none does); exact K9/K10 counts.
   (c) Gradients, kernel branch against plain branch on the card at phase
   10b's bounds: K9 windowed (gemma3's tail layer, window 1024, 1 x 1536),
   K9 at llava's S 3968 (the 8 dead heads' ``wq`` gradient exactly 0 on
   both) and K10 at zamba2's N 64 (one group of 9 Mamba2 layers and the
   shared block). (d) ``examples/train_100m`` at its defaults for 3 rounds:
   the reference's JSON keys, K1 once a round, K9 twice a layer a step.
17. The launch tooling: every arch's ``--print-plan``, three dry-runs on
   the meta device and the 1 x 1 plan of phase 10d's round against that
   round on the card.
18. The sharded model, on two rank processes sharing the card over a gloo
   group (``core/collectives.py`` stages the card's tensors through pinned
   host memory; NCCL refuses two ranks on one device), from a
   ``FileStore``; they load the kernels the parent built. (a) fedyolov3 at
   full width, img 416, batch 2, sgd 0.05, 2 rounds a case: dense, eq6
   (top 4) and quant8 on a (1, 2) mesh at C 2 (K1 once a round on the
   rank's column block; quant8 gathers its columns and runs K5a on whole
   rows), fedsgd at C 2 and the buffered eq6 engine at C 4 (a flush every
   2, alpha 0.5) on a (2, 1) mesh; rank 0 runs each meshless from the same
   seed, as its twin (``microbatches`` 2: the parts the ranks take) and as
   the plain round, and holds the gathered result to both at phase 10c's
   bounds (rtol 1e-4 / atol 1e-5; quant8: a gradient that differs by
   rounding moves up to 1e-4 of the values across a half step, each by at
   most 1e-3), eq6's upload choices and the engine's records equal.
   (b) qwen3-1.7b at its widths cut to 2 layers (N 411,838,976), one eq6
   adamw 3e-3 round at C 2, one step at 2 x 128 (1 x 128 a model rank) on
   a (1, 2) mesh: each rank's state bytes along the flat dim exactly half
   the meshless state's, beside the dry-run's per-device bytes of the same
   plan; the peak, the round's ms, the host collectives' seconds; the loss
   against rank 0's meshless run at rtol 1e-5. (c) In this process, while
   the ranks run: the launcher's 1 x 1 NCCL mesh, one fedsgd round and one
   buffered flush bitwise equal to meshless.
19. The legacy tree layout (``FedConfig(state_layout="tree")``: client-stacked
   param trees, pack -> train -> aggregate -> unpack each round), each run
   from the same seed-0 state as a flat twin and held to it bitwise
   (params, moments, aggregator state, losses). (a) fedyolov3 at full
   width, img 416, C 3, batch 2, sgd 0.05, 2 rounds through ``FLServer``
   each of dense, eq6 (top 4), static_topn (top 2), quant8 on the
   launcher's 1 x 1 NCCL mesh (K5a) and quant8 without a mesh (K4): K1
   exactly once a dense, eq6 and static_topn round, K5a and K4 once a
   quant8 round; ms a round and the peak of both layouts. (b) qwen3-1.7b
   at its widths cut to 2 layers (N 411,838,976), C 2, 1 x 128, sgd 0.05,
   2 rounds of eq6 (top 2) and of static_topn (top 2) through
   ``build_fed_round``; then ``core.fedavg.aggregate_eq6`` and
   ``aggregate_quant8`` on the card against the packed eq6 (K1) and
   quant8 (K4) aggregators on one input: eq6 within 1e-5 with the same
   upload choices and sums within rtol 1e-5 / atol 1e-3, quant8 within two
   quantization steps (the CPU tests' bounds).

The line before the last is the kernel summary; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense tensor cores; a 3xTF32 product costs three
# f32 ops per evaluated (i, j) pair of the scan (4 for ix, 4 for iy, 2 for
# inter, 4 for the IoU, 1 compare) and per box for corners and area
OPS_PER_PAIR, OPS_PER_BOX = 15, 12

# f32 ops per (n, m) pair of the pairwise IoU: 4 for ix, 4 for iy, 2 for
# inter, 4 for the IoU (union, floor, divide); GIoU adds 10; and per box
# for its corners and area
IOU_OPS_PER_PAIR, GIOU_OPS_PER_PAIR, IOU_OPS_PER_BOX = 14, 24, 12

# phase 2: (B, N) of the NMS cases: the served (8, 16) and eval's (8, 64); N
# = 33 a word edge of the bitmask kernel; N = 1024 its largest, N = 2048
# the scan's
SHAPES = [(1, 1), (8, 16), (3, 33), (8, 64), (64, 100), (4, 1024), (2, 2048)]
KINDS = ["random", "ties", "degenerate", "all_suppressed", "max_keep", "score_thresh", "iou_ties"]
# the largest N the bitmask kernel takes (csrc/nms.cu kMaskMaxN)
NMS_MASK_MAX_N = 1024
# 1024 requests, so that p99 has 10 samples beyond it; 64 distinct scenes
REQUESTS_PER_CLIENT, CLIENTS, SCENES, IMG = 128, 8, 64, 416
# phase 4: (C, N, B) cases of the bucket reduce beside the main path's,
# and (B, N, M) cases of the pairwise IoU (the first is the eval's shape)
K1_RANDOM = [(4, 3000, 3), (3, 1024, 5), (2, 77, 2), (64, 1 << 20, 8)]
IOU_SHAPES = [(12, 64, 3), (1, 1, 1), (8, 128, 128), (2, 1000, 1000), (4, 300, 7)]
# phase 5b: the launcher's training run
TRAIN_ROUNDS, TRAIN_EVAL_EVERY, TRAIN_CLIENTS, TRAIN_BATCH = 10, 5, 3, 8
# phase 6: ragged (C, N, block) cases of K4/K7, (C, G, N) of K6, (C, N,
# participation) of K8 beside the main path's shapes
QUANT_RAGGED = [(9, 5001, 1024), (1, 77, 64), (6, 2500, 256), (2, 4096 * 3 + 8, 4096), (3, 1030, 1024),
                # the whole-tile kernel's edges (block 1024, N % 4 == 0): C = 17; the
                # generic kernel's smallest and largest block at C = 1. Phase 6 adds
                # N one whole persistent grid stride long and one with a partial
                # last stride and block, and rows 4 bytes off a 16-byte boundary
                (17, 5000, 1024), (1, 5000, 4), (1, 5003, 4096)]
# (C, N, block) of the rows phase 6 starts 4 bytes into a buffer (the scalar path)
QUANT_UNALIGNED = [(3, 5000, 1024), (2, 4096 * 3, 4096)]
# (C, N, block) of rows whose values span many binades (phase 6's ``wide``):
# the whole-tile kernel's division in and out of the range it runs fast
QUANT_WIDE = [(3, 65536 + 12, 1024), (2, 1 << 20, 1024), (3, 5001, 1024)]
QUANT4_KEYS = [("nearest", 0), ("stochastic", 12345), ("stochastic", 2 ** 32 - 1)]
GROUPED_RAGGED = [(32, 8, 2101), (9, 3, 77), (2, 1, 1000), (4, 4, 1003), (12, 2, 4099)]
MASKED_RAGGED = [(9, 5003, [1] * 9), (1, 64, [1]), (3, 10, [0, 0, 0]), (5, 4096, [0, 1, 1, 0, 1])]
# phase 7: the uplink modes and their launcher runs
UPLINK_ROUNDS = 3
UPLINK_EXACT = [("quant8", {}), ("quant4", dict(quant4_mode="stochastic", quant4_seed=1)),
                ("secure", dict(secure_domain="int8", secure_session=2)),
                ("topk_ef", dict(topk_frac=0.1, topk_quant="quant4", quant4_mode="stochastic")),
                ("hier", dict(n_clients=4, group_size=2, hier_base="dense"))]
UPLINK_TOL = [("fedavgm", dict(server_lr=1.0)), ("fedadam", dict(server_lr=0.02)),
              ("trimmed_mean", dict(trim_ratio=0.34))]
# the launcher's quant8 runs on its 1 x 1 client mesh: K5a, not K4 (K4's path
# is a meshless FLServer run in the same phase)
UPLINK_RUNS = {"quant8": ([], {"quantize_rows": 1, "quant8_reduce": 0}),
               "quant4": ([], {"quant4_reduce": 1}),
               "secure": ([], {"masked_u32_sum": 1}),
               "topk_ef": ([], {"packed_bucket_reduce": 1}),
               "hier": (["--clients", "4", "--group-size", "2", "--hier-base", "eq6"],
                        {"grouped_reduce": 1, "packed_bucket_reduce": 1})}
# phase 8: ((B, H, Hkv, S, hd), causal, window, dtype) cases of K9, the qwen3
# prefill's first; (B, S, H, P, N, chunk, dtype) cases of K10, the mamba2
# prefill's first; the reference's tolerances per dtype
FLASH_CASES = [((4, 16, 8, 1024, 128), True, 0, torch.float32),
               ((4, 16, 8, 1024, 128), True, 0, torch.bfloat16),
               ((2, 8, 4, 512, 128), True, 64, torch.float32),
               ((2, 8, 4, 512, 128), True, 128, torch.float32),
               ((2, 8, 4, 512, 128), False, 0, torch.float32),
               ((2, 8, 8, 512, 128), True, 0, torch.float32),
               ((4, 16, 8, 1024, 64), True, 0, torch.float32),
               ((2, 4, 2, 128, 128), True, 0, torch.float32),
               ((2, 4, 2, 64, 128), True, 0, torch.float32),
               # the edges of the 128-row query tile and the 64-row key tile
               ((1, 4, 2, 192, 128), True, 0, torch.float32),
               ((1, 4, 2, 192, 64), True, 0, torch.bfloat16),
               ((1, 4, 2, 384, 128), True, 100, torch.float32),
               ((1, 4, 1, 384, 64), True, 130, torch.float32),
               ((1, 2, 1, 256, 64), False, 96, torch.float32),
               # phase 15's prefills: zamba2's shared block at hd 80, gemma3's
               # 1024 window past S = 1024, llava's 64 q heads (8 dead) over 8,
               # grok's 48 heads, minitron's 32
               ((4, 32, 32, 1024, 80), True, 0, torch.float32),
               ((4, 32, 16, 1536, 128), True, 1024, torch.float32),
               ((2, 64, 8, 3968, 128), True, 0, torch.float32),
               ((4, 48, 8, 1024, 128), True, 0, torch.float32),
               ((4, 32, 8, 1024, 128), True, 0, torch.float32),
               # phase 16d's train_100m: 8 q heads over 4 at hd 640 / 8 = 80, S 128
               ((2, 8, 4, 128, 80), True, 0, torch.float32)]
SSD_CASES = [(4, 1024, 64, 64, 128, 128, torch.float32), (1, 32, 2, 8, 4, 8, torch.float32),
             (2, 64, 3, 16, 8, 16, torch.float32), (1, 128, 1, 64, 16, 32, torch.float32),
             (4, 1024, 64, 64, 128, 128, torch.bfloat16),
             (4, 4096, 12, 64, 128, 128, torch.float32),
             (2, 1024, 8, 64, 128, 64, torch.float32),  # chunk 64
             (1, 1024, 17, 64, 128, 128, torch.float32),  # groups of 2 heads, the last of 1
             (1, 256, 4, 128, 128, 128, torch.float32),  # two 64-column head blocks
             (1, 256, 3, 100, 36, 64, torch.bfloat16),
             (4, 1024, 80, 64, 64, 128, torch.float32)]  # zamba2's prefill (phase 15)
KERNEL_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# phase 9: the LM serve path at full width, and the kernel each arch runs
LM_ARCHS = [("qwen3-1.7b", "flash_attention"), ("mamba2-1.3b", "ssd_chunk_scan")]
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32
PREFILL_TOL, DECODE_TOL = 5e-4, 5e-3
# phase 10: K11's (C, N) cases; the gradient check's sequence and pins (the
# reference's, tests/test_kernels.py:96-142); the LM training path
FEDAVG_C, FEDAVG_N = (1, 2, 3, 8), (1, 1023, 1025, 4_194_305)
GRAD_SEQ, GRAD_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1024, 1e-4, 5e-3, 5e-4
LM_TRAIN_CLIENTS, LM_TRAIN_ROUNDS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 2, 3, 1, 1024
LM_TRAIN_PEAK_GIB = 75.0
# phase 11: ragged (C, N, block) cases of K5a/K5b beside the main path's (3,
# N, 1024) and the ties rows (C = 17 at 680 units is the whole-tile kernel's;
# phase 11a adds the smallest launch that kernel takes and one unit less,
# N one whole persistent grid stride, a partial last stride and block,
# QUANT_UNALIGNED's rows 4 bytes off 16 and QUANT_WIDE's); the compact
# launcher runs; fedsgd at full width
ROWQ_RAGGED = [(9, 5001, 1024), (1, 4097, 1024), (5, 3333, 128), (2, 4096 * 3 + 8, 4096),
               (3, 1030, 1024), (1, 77, 64), (17, 40_000, 1024)]
COMPACT_ROUNDS, COMPACT_BUDGET = 3, 2
FEDSGD_ROUNDS, FEDSGD_PEAK_GIB = 3, 75.0
# phase 12: the async control plane at fedyolov3's full width with
# examples/fed_yolo.py's settings (sgd 1e-3, batch 8, img 416). 12a:
# buffered eq6, a flush every 2 of 3 landings, alpha 0.5, max_staleness 2,
# uplinks spread 0.5; seed 4's draws land an update at staleness 1 and drop
# one within the 6 flushes (the event plane is host NumPy, the same on any
# machine). 12b: streaming dense against its buffered twin, 16 clients, a
# flush every 8, max_staleness 4 (a ring of 5 rows), stateless sgd
ASYNC_SEED, ASYNC_FLUSHES, ASYNC_LAUNCHER_FLUSHES = 4, 6, 3
ASYNC_BUFFERED = dict(n_clients=3, buffer_size=2, staleness_alpha=0.5, max_staleness=2)
STREAM_FLUSHES, STREAM_TOL = 4, 1e-5
ASYNC_STREAM = dict(n_clients=16, buffer_size=8, max_staleness=4)
# 12c: the arrival engine and the replay on the wire's default run meta
# (the reference's harness.make_meta(reduced=True)) under dense and quant8;
# (kind, client, t) or (kind, client, seq, t): 5 flushes, staleness up to 2
# kept, a landing at staleness 4 dropped
REPLAY_META = dict(arch="qwen3-1.7b", reduced=True, overrides={}, n_clients=4, buffer_size=2,
                   max_staleness=2, staleness_alpha=0.5, aggregation="dense", local_steps=1,
                   batch=2, seq=16, seed=0, lr=0.05, transport="socket", wire_codec="dense",
                   quant_block=1024, queue_cap=0, heartbeat_s=0.2, heartbeat_timeout_s=2.0)
REPLAY_PLAN = [("dispatch", c, 0.0) for c in range(4)] + [
    ("land", 0, 0, 1.0), ("land", 1, 0, 1.2), ("dispatch", 0, 1.3), ("dispatch", 1, 1.3),
    ("land", 0, 1, 2.0), ("land", 1, 1, 2.2), ("dispatch", 0, 2.3), ("dispatch", 1, 2.3),
    ("land", 2, 0, 3.0), ("land", 0, 2, 3.2), ("dispatch", 2, 3.3), ("dispatch", 0, 3.3),
    ("land", 1, 2, 4.0), ("land", 0, 3, 4.2), ("land", 3, 0, 4.5),
    ("dispatch", 0, 4.6), ("dispatch", 1, 4.6),
    ("land", 3, 1, 5.0), ("land", 2, 1, 5.2)]
REPLAY_QUANT_TOL = 1e-5
# 13: the wire at full width. qwen3-1.7b at its published widths with its
# depth cut to 2 layers: a DISPATCH frame carries the dense f32 row and both
# packages cap a frame at MAX_FRAME = 2^31 bytes (full depth: 6.88 GB a row),
# and at C = 4 a full-depth server state alone is 41 GB. 4 clients in 2
# worker processes, a flush every 2 landings, batch 1 x 128
WIRE_META = dict(arch="qwen3-1.7b", reduced=False, overrides={"n_layers": 2}, n_clients=4,
                 buffer_size=2, max_staleness=2, batch=1, seq=128)
# 2 flushes a run: a socket run's seconds are its host copies, and phase
# 15 shares the script's 1200 s
WIRE_FLUSHES = 2
# 13a runs quant8 alone, replayed within 1e-5: with a dense run too (about
# 185 s with its replay) the script took 1111 s of its 1200 on the H100;
# 13b's dense run is replayed bitwise
WIRE_13A = (("quant8", REPLAY_QUANT_TOL),)
# 13b: one snapshot (after landing 2), the kill after landing 3; the
# recovery replays landing 3 and landing 4 makes the second flush
WIRE_SNAPSHOT_EVERY, WIRE_KILL = 2, "kill@3"
# a worker waits for its next dispatch while the others' gigabyte frames
# move; the recovery reads a 6.6 GB snapshot before it rebinds
WIRE_GROUPS = [{"client_ids": [0, 1], "extra": ["--dispatch-timeout", "300"]},
               {"client_ids": [2, 3], "extra": ["--dispatch-timeout", "300"]}]
WIRE_PATIENT = ["--connect-retries", "60", "--backoff-max", "2.0"]
WIRE_DEADLINE_S = 600.0
WIRE_RUN_KEYS = ("final_loss", "rounds", "mode", "transport", "wire_codec", "landed", "dropped",
                 "mean_staleness", "bytes_up", "bytes_down", "deadline_hit", "recovered",
                 "snapshots", "wal_events", "crc_errors", "faults_injected")
WIRE_RESTORE_KEYS = ("restored_from", "wal_events", "events_replayed", "version",
                     "flushes_recovered", "staged_window", "final_loss")
# 14: the multi-task platform at full width. The LM task is qwen3-1.7b at its
# published widths with its depth cut to 2 layers (N = 411,838,976), as
# phase 13 cuts it: the example's C = 3 under adamw at full depth needs 3
# rows of 6.88 GB, twice that again for adamw's moments, and the gradients,
# past the card's 80 GB. The detector is fedyolov3 at full width on the
# per-step 416x416 scenes. 14b shares one clock between a sync detector
# and an async LM; 14c serves 14a's detector; 14d runs the quickstart
PLATFORM_LM_LAYERS, PLATFORM_LM_BATCH, PLATFORM_SEQ = 2, 2, 128
PLATFORM_LM_ROUNDS, PLATFORM_YOLO_ROUNDS, PLATFORM_PASSES = 8, 6, 8
PLATFORM_SECURE_TOL, PLATFORM_PEAK_GIB = 1e-3, 45.0
CLOCK_SYNC_ROUNDS, CLOCK_FLUSHES = 3, 3
PLATFORM_REQUESTS, PLATFORM_QUICKSTART_ROUNDS = 16, 5
# 15: slice 7c, the other LM families served through the launcher at their
# published widths, f32 weights from seed 0 drawn on the card, and float32
# caches (``dtype="float32"``) so that decode is held to a full forward at
# the decode tolerance. (arch, layers kept (0: all), batch, prompt, K9 and
# K10 launches a prefill). Depth is cut where f32 weights pass 80 GB
# (gemma3 62 layers 100.6 GiB, llava 60 129.9, grok 64 1176): gemma3 to 2
# period groups and a 2-layer tail, so its tail and both window kinds stay;
# llava's prompt makes 2880 image tokens + 1088 a multiple of 128 (K9's
# branch); gemma3's 1536 puts the prompt 512 past its 1024-token window
FAMILY_ROWS = [("granite-moe-1b-a400m", 0, 4, 1024, 24, 0), ("grok-1-314b", 2, 4, 1024, 2, 0),
               ("gemma3-27b", 14, 4, 1536, 14, 0), ("zamba2-2.7b", 0, 4, 1024, 6, 54),
               ("llava-next-34b", 6, 2, 1088, 6, 0), ("minitron-8b", 0, 4, 1024, 32, 0)]
FAMILY_NEW, FAMILY_PEAK_GIB = 16, 75.0
# 16: slice 7d, the other LM families trained through the launcher
# (``train_lm``) at their published widths, f32, random weights from seed
# 0, the launcher's eq6, C 2, 2 rounds of one local step, batch 1. (arch,
# layers kept (0: all), positions a sequence, optimizer and lr, K9 and K10
# launches a local step). Depth is cut where a round passes 75 GiB at
# about 40 bytes a parameter (phase 10d): zamba2 to 2 groups (18 layers,
# the shared block applied twice), llava to 1 layer (1 x (2880 + 1088):
# the plain attention backward's (1, 64, 3968, 3968) f32 buffers), gemma3
# to a tail of 2 windowed layers under sgd (a period group with its global
# layer is 3.89e9 parameters, about 87 GiB even under sgd), 512 positions
# past its 1024 window; grok (5.73e9 parameters a layer) only in 16b
FAMILY_TRAIN_ROWS = [("granite-moe-1b-a400m", 0, 1024, "adamw", 3e-3, 48, 0),
                     ("hubert-xlarge", 0, 1024, "adamw", 3e-3, 0, 0),
                     ("zamba2-2.7b", 18, 1024, "adamw", 3e-3, 4, 36),
                     ("llava-next-34b", 1, 3968, "adamw", 3e-3, 2, 0),
                     ("gemma3-27b", 2, 1536, "sgd", 0.05, 4, 0)]
FAMILY_TRAIN_CLIENTS, FAMILY_TRAIN_ROUNDS = 2, 2
# 16b: one masked adamw eq6 round of each new family, reduced, on the card
# against the host (phase 10c's settings and bounds;
# tests/test_torch_lm_families_train.py's cases): (case, arch, overrides)
FAMILY_TRAIN_REDUCED = [("moe-gshard", "granite-moe-1b-a400m", {}),
                        ("moe-sort", "granite-moe-1b-a400m", {"moe_impl": "sort"}),
                        ("gemma3", "gemma3-27b", {"n_layers": 8}),
                        ("hybrid", "zamba2-2.7b", {"n_layers": 4}),
                        ("vlm-padded", "llava-next-34b",  # head_dim 64: K9 takes hd
                         # a multiple of 16 (the CPU tests' 256 / 6 = 42 is not)
                         {"n_heads": 6, "n_kv_heads": 2, "q_group_pad": 4, "head_dim": 64}),
                        ("audio", "hubert-xlarge", {})]
# 16c: gradients through K9 windowed (gemma3's tail layer, window 1024, hd
# 128), K9 at llava's S 3968 with 8 dead heads, and K10 at zamba2's N 64
# (one group: 9 Mamba2 layers and the shared block), phase 10b's bounds:
# (arch, layers kept, positions, K9 and K10 launches)
FAMILY_GRAD_ROWS = [("gemma3-27b", 1, 1536, 2, 0), ("llava-next-34b", 1, 3968, 2, 0),
                    ("zamba2-2.7b", 9, 1024, 2, 18)]
# 16d: examples/train_100m at its defaults (4 clients, batch 2 x 128)
TRAIN_100M_ROUNDS = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def make_case(kind: str, B: int, N: int, seed: int = 0):
    """-> (boxes (B, N, 4) f32, scores (B, N) f32, iou_thresh, score_thresh,
    max_keep), the same case kinds as tests/test_torch_detect.py;
    ``iou_ties`` puts boxes 1/4 wide on a 1/16 grid, so the IoUs of boxes
    2/16 apart land exactly on the threshold f32(1/3)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.1, 0.9, (B, N, 2))
    wh = rng.uniform(0.02, 0.5, (B, N, 2))
    scores = rng.uniform(0, 1, (B, N))
    iou, sthr, mk = 0.4, 0.0, 0
    if kind == "ties":
        scores = np.round(scores * 4) / 4
        xy[:, 1::2] = xy[:, 0::2][:, : xy[:, 1::2].shape[1]]
    elif kind == "degenerate":
        wh[:, 0::3, 0] = 0.0
        wh[:, 1::3] *= -1.0
        wh[:, 2::5, 1] = 0.0
    elif kind == "all_suppressed":
        xy = 0.5 + rng.uniform(-0.01, 0.01, (B, N, 2))
        wh = 0.3 + rng.uniform(-0.01, 0.01, (B, N, 2))
        iou = 0.5
    elif kind == "max_keep":
        xy[..., 0] = np.linspace(0.0, 1.0, N)[None]
        xy[..., 1] = 0.5
        wh[:] = 0.5 / max(N, 1)
        mk = max(1, N // 3)
    elif kind == "score_thresh":
        sthr = 0.5
    elif kind == "iou_ties":
        xy = rng.integers(4, 13, (B, N, 2)) / 16.0
        wh = np.full((B, N, 2), 0.25)
        iou = 1.0 / 3.0
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    return boxes, scores.astype(np.float32), iou, sthr, mk


def make_iou_case(kind: str, B: int, N: int, M: int, seed: int = 0):
    """-> (a (B, N, 4), b (B, M, 4)) f32 center-format boxes, the case kinds
    of tests/test_torch_detect.py: ``degenerate`` sets zero widths, zero
    heights and negative extents and repeats a-boxes in b."""
    rng = np.random.default_rng(seed)

    def boxes(n):
        return np.concatenate([rng.uniform(0.1, 0.9, (B, n, 2)), rng.uniform(0.02, 0.5, (B, n, 2))], -1)

    a, b = boxes(N), boxes(M)
    if kind == "degenerate":
        for x in (a, b):
            x[:, 0::3, 2] = 0.0
            x[:, 1::4, 2:] *= -1.0
            x[:, 2::5, 3] = 0.0
        k = min(N, M) // 2
        b[:, :k] = a[:, :k]
    return a.astype(np.float32), b.astype(np.float32)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


# launches of a one-element kernel on each side of the traced calls, one
# entry per try: late in this script a bare trace records 0-4 of 5 launches
TRACE_FILLERS = (256, 4096)


def device_ms(fn, kernel: str, reps: int = 5, launches: int = 1) -> tuple[float, str]:
    """Device time (ms) of the CUDA kernel named ``kernel`` per call of
    ``fn``, which launches it ``launches`` times, and where it comes from.

    "profiler": the kernel's total device time in a trace of ``reps`` calls
    that recorded all ``reps * launches`` launches. A trace can miss the
    launches near its edges, more of them the longer the process has run,
    so the calls sit between launches of a one-element fill before and a
    one-element add after, more on each try (``TRACE_FILLERS``). "events":
    no try recorded every launch, and the time is that of ``reps`` calls
    back to back between two CUDA events, host gaps included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = reps * launches
    one = torch.zeros(1, device="cuda")
    for fillers in TRACE_FILLERS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(fillers):
                one.fill_(1.0)
            for _ in range(reps):
                fn()
            for _ in range(fillers):
                one.add_(1.0)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        mine = [e for e in rows if kernel in e.key]
        count = sum(e.count for e in mine)
        if count == want:
            return sum(e.device_time_total for e in mine) / reps / 1e3, "profiler"
        others = ", ".join([f"{e.count} x {e.key[:60]}" for e in rows if kernel not in e.key][:4])
        print(f"device_ms {kernel}: the trace with {fillers} fillers a side recorded {count} of "
              f"{want} launches; beside them {others or 'nothing'}", flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "events"


def launch_floor_ms() -> tuple[float, str]:
    """The card's launch floor: the device time of a one-element kernel (a
    multiply of one f32 in place), by :func:`device_ms`. No kernel's device
    time can fall below it, whatever its bytes and operations."""
    one = torch.ones(1, device="cuda")
    return device_ms(lambda: one.mul_(1.0), "MulFunctor", reps=20)


def roofline(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of HBM traffic and ``ops`` f32
    operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reduce_bound_ms(C: int, N: int, B: int) -> tuple[float, str]:
    """K1 reads x (C*N f32) and ids (N int32), the (C, B) table and the mask
    once, writes num and den (N f32 each); per element and client it does
    one weight product, one multiply-add pair for num and one add for den."""
    return roofline(4 * (C * N + N + C * B + C + 2 * N), 4 * C * N)


def iou_bound_ms(B: int, N: int, M: int, giou: bool) -> tuple[float, str]:
    """K2 reads B*(N+M) boxes (16 bytes each) and writes B*N*M f32."""
    per_pair = GIOU_OPS_PER_PAIR if giou else IOU_OPS_PER_PAIR
    return roofline(B * (N + M) * 16 + B * N * M * 4,
                    B * N * M * per_pair + B * (N + M) * IOU_OPS_PER_BOX)


def scan_bound_ms(keep_s, N: int) -> tuple[float, str]:
    """Least time for the scan on these inputs: the bytes it must move (boxes
    and valid in, keep out) over HBM rate, or the f32 ops these inputs need
    (one IoU per later box for each box still kept at its step) over the f32
    peak, whichever is larger."""
    B = keep_s.shape[0]
    nbytes = B * N * (16 + 4 + 4)
    kept_pos = keep_s.nonzero()[:, 1]
    pairs = int((N - 1 - kept_pos).sum())
    return roofline(nbytes, OPS_PER_PAIR * pairs + OPS_PER_BOX * B * N)


def phase2(dev, card: str) -> int:
    """K3 against its plain version on the card, bitwise, over KINDS x
    SHAPES (the bitmask kernel up to N = 1024, the scan at 2048). -> the
    number of cases."""
    from repro_torch.kernels import detect, ops, ref

    n_cases = 0
    for kind in KINDS:
        for B, N in SHAPES:
            boxes, scores, iou, sthr, mk = make_case(kind, B, N)
            tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
            kern = ops.nms(tb, ts, iou_thresh=iou, score_thresh=sthr, max_keep=mk)
            plain = ops.nms(tb, ts, iou_thresh=iou, score_thresh=sthr, max_keep=mk, impl="ref")
            torch.cuda.synchronize()
            check(same_bits(kern, plain), f"nms {kind} B={B} N={N}: kernel != plain")
            _, boxes_s, valid_s = ref.sort_by_score(tb, ts, sthr)
            keep_k = detect.nms_keep(boxes_s, valid_s, iou)
            keep_p = ref.nms_keep(boxes_s, valid_s, iou)
            torch.cuda.synchronize()
            check(same_bits(keep_k, keep_p), f"nms_keep {kind} B={B} N={N}: kernel != plain")
            k_ms = time_ms(lambda: detect.nms_keep(boxes_s, valid_s, iou))
            # the plain scan at N >= 1024 takes 0.3-0.7 s a call on the host's clock: 3 timed
            # calls after one warm-up keep phase 2 near a minute
            p_ms = time_ms(lambda: ref.nms_keep(boxes_s, valid_s, iou),
                           **(dict(reps=20) if N < 1024 else dict(reps=3, warmup=1)))
            n_cases += 1
            print(f"phase2 {kind:14s} B={B:3d} N={N:5d} kept={int(kern.sum()):5d} bitwise-equal "
                  f"({'bitmask' if N <= NMS_MASK_MAX_N else 'scan'}) kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f}  [{card}]", flush=True)
    return n_cases


def served_model(dev):
    """Phase 3's detection service operands: (cfg, fed, fedyolov3 at full
    width with random weights from seed 0 on ``dev``, SCENES + 8 synthetic
    scenes at IMG from seed 7)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data import synthetic
    from repro_torch.models.yolov3 import FedYOLOv3

    cfg = get_arch("fedyolov3")
    fed = FedConfig(n_clients=1)  # serve_batch 8, serve_max_detections 16
    model = FedYOLOv3(cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    imgs, _ = synthetic.scene_images(np.random.default_rng(7), SCENES + 8, IMG, cfg.vocab_size)
    return cfg, fed, model, imgs


def served_nms_operands(model, batch, fed):
    """The keep-mask kernel's operands in a served batch: (boxes_s (8, 16, 4),
    valid_s (8, 16)), score-sorted as ``core.detection`` hands them over."""
    from repro_torch.core import detection
    from repro_torch.kernels import ref

    with torch.inference_mode():
        _, scores_k, _, shifted = detection.candidates(model, batch, fed.serve_max_detections)
        _, boxes_s, valid_s = ref.sort_by_score(shifted, scores_k, detection.SCORE_THRESH)
    return boxes_s, valid_s


def served_nms(boxes_s, valid_s, card: str) -> dict:
    """K3 at the served shape on the served operands: bitwise against the
    plain version; kernel ms (CUDA events), device ms (profiler), plain ms,
    the bound, and the card's launch floor with the share of it reached."""
    from repro_torch.kernels import detect, ref

    keep_k = detect.nms_keep(boxes_s, valid_s, 0.5)
    keep_p = ref.nms_keep(boxes_s, valid_s, 0.5)
    torch.cuda.synchronize()
    check(same_bits(keep_k, keep_p), "served-shape keep mask: kernel != plain")
    st = {"max_abs_err": float((keep_k - keep_p).abs().max())}
    st["ms"] = time_ms(lambda: detect.nms_keep(boxes_s, valid_s, 0.5), reps=50)
    st["plain_ms"] = time_ms(lambda: ref.nms_keep(boxes_s, valid_s, 0.5), reps=50)
    # "nms_" names every NMS kernel of the port, before and after the bitmask
    st["device_ms"], st["device_ms_from"] = device_ms(lambda: detect.nms_keep(boxes_s, valid_s, 0.5),
                                                      "nms_", reps=20)
    st["bound_ms"], st["bound_by"] = scan_bound_ms(keep_k, boxes_s.shape[1])
    st["library_ms"] = None  # no PyTorch call computes a greedy keep mask
    st["launch_floor_ms"], st["launch_floor_ms_from"] = launch_floor_ms()
    print(f"phase3 K3 at the served {tuple(valid_s.shape)}: kernel_ms={st['ms']:.5f} device_ms="
          f"{st['device_ms']} ({st['device_ms_from']}) plain_ms={st['plain_ms']:.5f}; launch floor "
          f"{st['launch_floor_ms']} ms ({st['launch_floor_ms_from']}), reached "
          f"{st['launch_floor_ms'] / st['device_ms']:.0%} of it; byte/op bound "
          f"{st['bound_ms']:.3e} ({st['bound_by']})  [{card}]", flush=True)
    return st


def phase4(dev, card: str) -> dict:
    """K1 and K2 against their plain versions on the card, bitwise; times
    and bounds. -> {kernel name: summary fields}."""
    from repro_torch.configs import get_arch
    from repro_torch.core import packing
    from repro_torch.kernels import detect, pack, ref
    from repro_torch.models import yolov3

    # -- K1: the main path's shape first, with fedyolov3's bucket ids
    cfg = get_arch("fedyolov3")
    spec = packing.build_pack_spec(cfg, yolov3.template(cfg))
    g = torch.Generator(device=dev).manual_seed(0)
    main_ids = packing.bucket_ids_on(spec, dev)
    cases = [("main", 3, spec.n_total, spec.n_buckets, main_ids,
              torch.tensor([1.0, 0.0, 1.0], device=dev))]
    for C, N, B in K1_RANDOM:
        ids = torch.randint(0, B, (N,), generator=g, device=dev, dtype=torch.int32)
        cases.append(("random", C, N, B, ids, None))
        cases.append(("random", C, N, B, ids, (torch.arange(C, device=dev) % 3 != 1).float()))
    k1 = {"cases": 0, "max_abs_err": 0.0}
    for kind, C, N, B, ids, mask in cases:
        x = torch.randn((C, N), generator=g, device=dev)
        wm = torch.rand((C, B), generator=g, device=dev)
        kern = pack.packed_bucket_reduce(x, wm, ids, mask)
        plain = ref.packed_bucket_reduce(x, wm, ids, mask)
        torch.cuda.synchronize()
        for a, b in zip(kern, plain):
            check(same_bits(a, b), f"bucket reduce {kind} C={C} N={N} B={B} "
                                   f"mask={mask is not None}: kernel != plain")
            k1["max_abs_err"] = max(k1["max_abs_err"], float((a - b).abs().max()))
        k_ms = time_ms(lambda: pack.packed_bucket_reduce(x, wm, ids, mask))
        p_ms = time_ms(lambda: ref.packed_bucket_reduce(x, wm, ids, mask), reps=5, warmup=1)
        bound, by = reduce_bound_ms(C, N, B)
        k1["cases"] += 1
        if kind == "main":
            k1.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by)
            k1["device_ms"], k1["device_ms_from"] = device_ms(
                lambda: pack.packed_bucket_reduce(x, wm, ids, mask), "bucket_reduce_kernel")
        print(f"phase4 bucket_reduce {kind:6s} C={C:3d} N={N:9d} B={B} mask={mask is not None!s:5s} "
              f"bitwise-equal kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bound:.4f} ({by})"
              f"  [{card}]", flush=True)
    print(f"phase4 bucket_reduce main path (3, {spec.n_total}): kernel {k1['ms']:.4f} ms "
          f"(device {k1['device_ms']}, {k1['device_ms_from']}) against a {k1['bound_ms']:.4f} ms bound "
          f"({k1['bound_ms'] / k1['ms']:.3f} of it)  [{card}]", flush=True)

    # -- K2: the eval's shape first
    k2 = {"cases": 0, "max_abs_err": 0.0}
    for B, N, M in IOU_SHAPES:
        for kind in ("random", "degenerate"):
            a, b = make_iou_case(kind, B, N, M, seed=N + M)
            ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
            for giou in (False, True):
                kern = detect.pairwise_iou(ta, tb, giou=giou)
                plain = ref.pairwise_iou(ta, tb, giou)
                torch.cuda.synchronize()
                check(same_bits(kern, plain), f"pairwise_iou {kind} {(B, N, M)} giou={giou}: "
                                              "kernel != plain")
                k2["max_abs_err"] = max(k2["max_abs_err"], float((kern - plain).abs().max()))
                k2["cases"] += 1
            k_ms = time_ms(lambda: detect.pairwise_iou(ta, tb))
            p_ms = time_ms(lambda: ref.pairwise_iou(ta, tb))
            bound, by = iou_bound_ms(B, N, M, giou=False)
            if (B, N, M) == IOU_SHAPES[0] and kind == "random":
                k2.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by)
                k2["device_ms"], k2["device_ms_from"] = device_ms(
                    lambda: detect.pairwise_iou(ta, tb), "pairwise_iou_kernel")
            print(f"phase4 pairwise_iou {kind:10s} B={B:2d} N={N:4d} M={M:4d} IoU+GIoU bitwise-equal "
                  f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bound:.3e} ({by})  [{card}]",
                  flush=True)
    return {"packed_bucket_reduce": k1, "pairwise_iou": k2}


def phase5(dev, card: str) -> dict:
    """Federated training at full width: (a) card against host, (b) the
    launcher's path, then serving the trained model. -> launch counts."""
    import argparse
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.core import packing, rounds, serving
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.kernels import detect, pack
    from repro_torch.launch import train
    from repro_torch.models import yolov3
    from repro_torch.models.params import map_tree as mp_map
    from repro_torch.optim import sgd

    cfg = get_arch("fedyolov3")

    # -- (a) one round on the card and the same round on the host
    fed = FedConfig(n_clients=3, aggregation="eq6", topn=4, participation="masked",
                    agg_impl="kernel")
    gen, _, _ = detection_suite(cfg, fed, batch=2, img_size=64, pool_scenes=24)
    batch = next(gen)
    part = rounds.participation_input(fed, np.array([1, 0, 1], np.float32),
                                      np.array([0.5, 0.0, 0.5], np.float32))
    runs = []
    for where in (dev, torch.device("cpu")):
        state = rounds.make_state(cfg, fed, sgd(1e-3), torch.Generator().manual_seed(0), where)
        fr = rounds.build_fed_round(cfg, fed, sgd(1e-3))
        t0 = time.perf_counter()
        state, m = fr(state, rounds.to_device(batch, where), part)
        loss = float(m["loss"])
        runs.append((loss, state["params"].cpu(), time.perf_counter() - t0))
    (lc, pc, tc), (lh, ph, th) = runs
    gap = float((pc - ph).abs().max())
    rel = float(((pc - ph).abs() / (ph.abs() + 1e-5)).max())
    check(np.isfinite(lc) and abs(lc - lh) <= 1e-4 * abs(lh), f"card loss {lc} != host loss {lh}")
    check(torch.allclose(pc, ph, rtol=1e-4, atol=1e-5),
          f"card round params != host round params: max abs gap {gap:.3e}")
    print(f"phase5a one masked eq6 round, fedyolov3 full width img 64: card loss {lc!r} host loss "
          f"{lh!r} (rel gap {abs(lc - lh) / abs(lh):.3e}); params max abs gap {gap:.3e}, "
          f"max rel gap {rel:.3e} (held at rtol 1e-4 / atol 1e-5); card {tc:.3f} s host {th:.3f} s"
          f"  [{card}]", flush=True)

    # -- (b) the launcher's path at img 416
    with tempfile.TemporaryDirectory() as cos:
        args = train.build_parser().parse_args([
            "--task", "detection", "--full-size", "--device", str(dev), "--img-size", str(IMG),
            "--clients", str(TRAIN_CLIENTS), "--participation", "masked", "--max-participants", "2",
            "--fairness-rounds", "3", "--agg", "eq6", "--topn", "4", "--optimizer", "sgd",
            "--lr", "1e-3", "--local-steps", "1", "--batch", str(TRAIN_BATCH),
            "--rounds", str(TRAIN_ROUNDS), "--eval-every", str(TRAIN_EVAL_EVERY), "--store", cos,
        ])
        pack.packed_bucket_reduce.launches = 0
        detect.pairwise_iou.launches = 0
        detect.nms_keep.launches = 0
        t0 = time.perf_counter()
        run = train.train_detection(args, log=lambda msg: print(f"phase5b {msg}", flush=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"packed_bucket_reduce": pack.packed_bucket_reduce.launches,
                    "pairwise_iou": detect.pairwise_iou.launches,
                    "nms_keep": detect.nms_keep.launches}
        stored = run.summary["stored_rounds"]
    server = run.server
    losses = [r.loss for r in server.history]
    maps = [(e.round_idx, e.map50) for e in server.eval_history]
    n_evals = len(server.eval_history)
    check(len(losses) == TRAIN_ROUNDS and all(np.isfinite(losses)), f"losses {losses}")
    check(launches["packed_bucket_reduce"] == TRAIN_ROUNDS,
          f"K1 launched {launches['packed_bucket_reduce']} times in {TRAIN_ROUNDS} rounds")
    check([r for r, _ in maps] == [0, 5, 9], f"evals at rounds {[r for r, _ in maps]}")
    check(launches["pairwise_iou"] == n_evals, f"K2 launched {launches['pairwise_iou']} times "
                                               f"in {n_evals} evals")
    check(launches["nms_keep"] >= n_evals, f"K3 launched {launches['nms_keep']} times in {n_evals} evals")
    check(stored == [0, 5], f"COS holds rounds {stored}")
    check(all(0.0 <= m <= 1.0 for _, m in maps), f"mAP out of [0, 1]: {maps}")
    check(any(len(r.participants) < TRAIN_CLIENTS for r in server.history),
          "every round trained every client: the participation mask never bit")
    print(f"phase5b {TRAIN_ROUNDS} rounds in {wall:.2f} s; launches {launches}; COS rounds {stored}; "
          f"loss {' '.join(f'{x:.3f}' for x in losses)}; mAP@0.5 "
          f"{' '.join(f'r{r}={m:.4f}' for r, m in maps)}  [{card}]", flush=True)

    # -- serving the trained model through the service
    fed_s = FedConfig(n_clients=1)
    version = run.slot.snapshot().version
    imgs, _ = synthetic.scene_images(np.random.default_rng(11), 16, IMG, cfg.vocab_size)
    svc = serving.InferenceService(cfg, fed_s, run.slot, img_size=IMG, device=dev).start()
    try:
        with serving.InferenceClient(svc.host, svc.port, timeout=300.0) as cl:
            results = [cl.infer(im) for im in imgs]
            status = cl.status()
    finally:
        svc.stop()
    check(version == TRAIN_ROUNDS, f"published version {version}")
    check(all(r.version == version for r in results), "a RESULT of the trained model carries "
                                                      "another version")
    check(status["in_flight"] == 0, f"{status['in_flight']} requests dropped")
    print(f"phase5b trained model served: {len(results)} requests at version {version}, "
          f"{sum(len(r.detections) for r in results)} detections, 0 dropped  [{card}]", flush=True)

    # -- where a round's time goes: the whole round, aggregation alone (the
    # timed rounds write no checkpoint: the COS directory is gone)
    server.store = None
    gen, _, _ = detection_suite(cfg, server.fed, batch=TRAIN_BATCH, img_size=IMG, seed=1)
    nxt = next(gen)
    round_ms = time_ms(lambda: server.run_round(nxt), reps=3, warmup=1)
    packed = server.state["params"]
    w = torch.tensor([0.5, 0.0, 0.5], device=dev)
    mask = torch.tensor([1.0, 0.0, 1.0], device=dev)
    scratch = packed.clone()
    agg_ms = time_ms(lambda: server.aggregator.aggregate(scratch, w, server.state["agg"], mask))
    opt_row = {k: v[0].clone() for k, v in server.state["opt"].items()}
    grad = torch.randn_like(packed[0])
    opt_ms = time_ms(lambda: server.optimizer.update(scratch[0], grad, opt_row))
    # one client's local step at the training shape: forward (the loss) and
    # forward + backward (the loss and its packed gradient)
    spec, tpl = server.aggregator.ctx.spec, server.aggregator.ctx.template
    step = rounds.to_device(mp_map(lambda x: x[0, 0], nxt), dev)
    row = scratch[0].detach().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            yolov3.yolo_loss(packing.unpack_views(spec, row, tpl), step, cfg)

    def fwd_bwd():
        loss, _ = yolov3.yolo_loss(packing.unpack_views(spec, row, tpl), step, cfg)
        torch.autograd.grad(loss, row)

    fwd_ms, fwd_bwd_ms = time_ms(fwd, reps=5), time_ms(fwd_bwd, reps=5)
    print(f"phase5b ms per round {round_ms:.3f} (2 clients x batch {TRAIN_BATCH} at {IMG}): "
          f"aggregation {agg_ms:.3f} (eq6 scores + K1 + dispatch), local training and the rest "
          f"{round_ms - agg_ms:.3f}; per client step: forward {fwd_ms:.3f}, forward+backward "
          f"{fwd_bwd_ms:.3f}, optimizer (sgd, one row) {opt_ms:.3f}  [{card}]", flush=True)
    profile_round(lambda: server.run_round(nxt), card)
    return launches


def profile_round(fn, card: str) -> None:
    """Profile one training round: device time by kernel family and the
    idle share of the round's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.device_time_total > 0), reverse=True)
    if not rows:
        print(f"phase5b profile: not measured (the profiler recorded no device kernel)  [{card}]")
        return
    # cuDNN runs the convolutions as implicit GEMMs, FFTs and plain GEMMs
    # under many kernel names; forward and backward are split by events
    # (phase5b's "forward" and "forward+backward" lines), not here
    families = {"K1 bucket_reduce": ("bucket_reduce_kernel",),
                "K2 pairwise_iou": ("pairwise_iou_kernel",),
                "K3 nms_keep": ("nms_bitmask_kernel", "nms_scan_kernel"),
                "cuDNN convolutions": ("xmma", "cudnn", "fft", "implicit_convolve", "gemm",
                                       "conv")}
    total = sum(r[0] for r in rows)
    by_family = {name: 0.0 for name in families}
    by_family["elementwise, reductions, copies"] = 0.0
    for ms, _, key in rows:
        fam = next((n for n, keys in families.items() if any(k in key for k in keys)),
                   "elementwise, reductions, copies")
        by_family[fam] += ms
    for ms, cnt, key in rows[:12]:
        print(f"phase5b profile {ms:9.4f} ms x{cnt:4d}  {key[:100]}", flush=True)
    print(f"phase5b profile one round: wall {wall_ms:.3f} ms, device kernels {total:.3f} ms "
          f"(idle share {1 - total / wall_ms:.3f}); "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in by_family.items()) + f"  [{card}]", flush=True)


def flushed_device_ms(fn, kernel: str, flush_mb: int = 128) -> tuple[float, str]:
    """:func:`device_ms` of ``fn`` with a ``flush_mb`` MB write before each
    call, which evicts the 50 MB L2: the kernel's device time on a cold L2."""
    junk = torch.empty(flush_mb << 18, device="cuda")

    def flushed():
        junk.zero_()
        return fn()

    return device_ms(flushed, kernel)


def quant_bound_ms(C: int, N: int) -> tuple[float, str]:
    """K4/K7 read the (C, N) delta and (C,) weights once and write (N,); per
    element and client about 9 f32 operations (abs, max, divide, round or
    floor and add, two clips, two multiplies, one add) and, stochastic, 12
    integer operations of the hash, counted at the f32 rate."""
    return roofline(4 * (C * N + C + N), 21 * C * N)


def grouped_bound_ms(C: int, G: int, N: int) -> tuple[float, str]:
    """K6 reads (C, N) and the (C/G, G) weights once, writes (C/G, N); one
    multiply and one add per element read."""
    return roofline(4 * (C * N + C + (C // G) * N), 2 * C * N)


def masked_bound_ms(part: list[float], N: int) -> tuple[float, str]:
    """K8 reads (C,) participation and the N words of each participating row
    once (a row that sits out is never read), writes (N,) words; one add per
    word read."""
    active = sum(p > 0 for p in part)
    return roofline(4 * (active * N + len(part) + N), active * N)


def wide_rows(C: int, n: int, g: torch.Generator, dev) -> torch.Tensor:
    """(C, n) f32 rows whose 1024-blocks have an amax of 1.5 * 2^E, E uniform
    in [-60, 125) (so scales above 2^100 too), and elements 0-70 binades
    below it (some below 2^-90, some subnormal), exact zeros, and elements
    at half steps k + 1/2 of the block's scale for Q = 127 and Q = 7
    (quotients within an ulp of a tie): the whole-tile kernels' division in
    and out of the range it runs fast."""
    from repro_torch.core import packing

    nb = -(-n // 1024)
    top = torch.randint(-60, 125, (C, nb, 1), generator=g, device=dev).float()
    x = torch.exp2(top - 70 * torch.rand((C, nb, 1024), generator=g, device=dev))
    x = torch.where(torch.rand(x.shape, generator=g, device=dev) < 0.5, -x, x)
    amax = 1.5 * torch.exp2(top[..., 0])
    x[..., 0] = amax
    k = torch.randint(-7, 7, (C, nb, 16), generator=g, device=dev).float() + 0.5
    x[..., 1:17] = k * packing.exact_div(amax, 7.0)[..., None]
    x[..., 17:33] = (k * 18) * packing.exact_div(amax, 127.0)[..., None]
    x[..., 33::97] = 0.0
    return x.reshape(C, -1)[:, :n].contiguous()


def tile_stride_n(dev) -> int:
    """Elements of one pass of a whole-tile kernel's persistent grid over one
    row (SMs x 16 warps x 1024): K4/K7's grid stride, and K5a's at C = 1."""
    from repro_torch.kernels import pack as kpack

    return (torch.cuda.get_device_properties(dev).multi_processor_count
            * kpack.QUANT_TILE_WARPS_PER_SM * kpack.QUANT_TILE_BLOCK)


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values in rows that start 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    out = buf[1:].view(x.shape).copy_(x)
    check(out.is_contiguous() and out.data_ptr() % 16, "rows meant to be off 16 bytes are not")
    return out


def phase6(dev, card: str) -> dict:
    """K4, K6, K7 and K8 against their plain versions on the card, bitwise;
    times and bounds at the main path's shapes. -> {kernel: fields}."""
    from repro_torch.configs import get_arch
    from repro_torch.core import packing
    from repro_torch.kernels import ops
    from repro_torch.models import yolov3

    cfg = get_arch("fedyolov3")
    N = packing.build_pack_spec(cfg, yolov3.template(cfg)).n_total
    n_pad = N + (-N) % 1024  # the padded row secure's K8 reduces
    g = torch.Generator(device=dev).manual_seed(14)

    def delta(C, n):
        x = torch.randn((C, n), generator=g, device=dev) * 1e-3
        x[:, ::97] = 0.0  # exact zeros, and a block of tiny values
        x[0, :64] *= 1e-30
        return x, torch.rand(C, generator=g, device=dev)

    def wide(C, n):
        return wide_rows(C, n, g, dev), torch.rand(C, generator=g, device=dev)

    stats = {}

    def hold(name, kern, plain, what):
        k, p = kern(), plain()
        torch.cuda.synchronize()
        check(same_bits(k, p), f"{name} {what}: kernel != plain")
        st = stats.setdefault(name, {"cases": 0, "max_abs_err": 0.0})
        st["cases"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], float((k.double() - p.double()).abs().max()))

    def measure(name, kern, plain, bound, kernel_name, library=None, flushed=False):
        st = stats[name]
        st["ms"] = time_ms(kern)
        st["plain_ms"] = time_ms(plain, reps=5, warmup=1)
        st["device_ms"], st["device_ms_from"] = device_ms(kern, kernel_name)
        st["bound_ms"], st["bound_by"] = bound
        st["library_ms"] = time_ms(library) if library else None
        lib = "" if library is None else f" library_ms={st['library_ms']:.4f}"
        if flushed:
            st["flushed_l2_device_ms"], src = flushed_device_ms(kern, kernel_name)
            lib += f" flushed_l2_device_ms={st['flushed_l2_device_ms']} ({src})"
        print(f"phase6 {name} main path: kernel_ms={st['ms']:.4f} device_ms={st['device_ms']} "
              f"({st['device_ms_from']}) plain_ms={st['plain_ms']:.4f} bound_ms={st['bound_ms']:.4f} "
              f"({st['bound_by']}){lib}; "
              f"{st['cases']} cases bitwise-equal  [{card}]", flush=True)

    # -- K4 and K7: the quant8 / quant4 round's (3, N), then ragged cases, the
    # whole-tile kernel's grid-stride edges, and rows off a 16-byte boundary
    stride_n = tile_stride_n(dev)
    edges = [(3, stride_n, 1024), (3, stride_n + 100 * 1024 + 516, 1024)]
    for C, n, block, off in [(3, N, 1024, 0), *[(*case, 0) for case in QUANT_RAGGED + edges],
                             *[(*case, 1) for case in QUANT_UNALIGNED],
                             *[(*case, -1) for case in QUANT_WIDE]]:
        x, w = wide(C, n) if off < 0 else delta(C, n)
        if off > 0:  # the same rows, starting one float into a buffer
            x = unaligned(x)
        what = (f"C={C} N={n} block={block}" + (f" rows {4 * off} bytes off 16" if off > 0 else "")
                + (" wide" if off < 0 else ""))
        hold("quant8_reduce", lambda: ops.quant8_reduce(x, w, block=block),
             lambda: ops.quant8_reduce(x, w, block=block, impl="ref"), what)
        for mode, key in QUANT4_KEYS:
            hold("quant4_reduce", lambda: ops.quant4_reduce(x, w, key, mode=mode, block=block),
                 lambda: ops.quant4_reduce(x, w, key, mode=mode, block=block, impl="ref"),
                 f"{what} {mode} key={key}")
        if n == N:
            main_x, main_w = x, w
    measure("quant8_reduce", lambda: ops.quant8_reduce(main_x, main_w),
            lambda: ops.quant8_reduce(main_x, main_w, impl="ref"), quant_bound_ms(3, N),
            "quant_reduce_tile_kernel", flushed=True)

    def k7_nearest():
        return ops.quant4_reduce(main_x, main_w, 0, mode="nearest")

    stats["quant4_reduce"]["nearest_ms"] = time_ms(k7_nearest)
    stats["quant4_reduce"]["nearest_device_ms"] = device_ms(k7_nearest, "quant_reduce_tile_kernel")[0]
    measure("quant4_reduce", lambda: ops.quant4_reduce(main_x, main_w, 12345, mode="stochastic"),
            lambda: ops.quant4_reduce(main_x, main_w, 12345, mode="stochastic", impl="ref"),
            quant_bound_ms(3, N), "quant_reduce_tile_kernel", flushed=True)
    print(f"phase6 quant4_reduce nearest at the main path: kernel_ms="
          f"{stats['quant4_reduce']['nearest_ms']:.4f} device_ms="
          f"{stats['quant4_reduce']['nearest_device_ms']}  [{card}]", flush=True)

    # -- K6: hier's (4, N) with G = 2, then ragged cases
    for C, G, n in [(4, 2, N), *GROUPED_RAGGED]:
        x = torch.randn((C, n), generator=g, device=dev)
        wn = torch.rand((C // G, G), generator=g, device=dev)
        hold("grouped_reduce", lambda: ops.grouped_reduce(x, wn),
             lambda: ops.grouped_reduce(x, wn, impl="ref"), f"C={C} G={G} N={n}")
        if n == N:
            gx, gwn = x, wn
    bmm = torch.bmm(gwn.view(2, 1, 2), gx.view(2, 2, N)).view(2, N)
    torch.cuda.synchronize()
    print(f"phase6 grouped_reduce vs torch.bmm: max abs diff "
          f"{float((bmm - ops.grouped_reduce(gx, gwn)).abs().max()):.3e} (yardstick only)", flush=True)
    measure("grouped_reduce", lambda: ops.grouped_reduce(gx, gwn),
            lambda: ops.grouped_reduce(gx, gwn, impl="ref"), grouped_bound_ms(4, 2, N),
            "grouped_reduce_kernel",
            library=lambda: torch.bmm(gwn.view(2, 1, 2), gx.view(2, 2, N)))

    # -- K8: secure's padded (3, N) with [1, 0, 1], ragged cases, ring edges
    edges = torch.tensor([0, 1, -1, -2, 2 ** 31 - 1, -2 ** 31, 5, -5], dtype=torch.int32, device=dev)
    for C, n, part in [(3, n_pad, [1, 0, 1]), *MASKED_RAGGED, (4, 4097, [1, 1, 1, 1])]:
        rows = torch.randint(-2 ** 31, 2 ** 31, (C, n), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
        if n == 4097:  # words at 0 and next to 2^32 in every row: the sum wraps
            rows = edges[torch.randint(0, len(edges), (C, n), generator=g, device=dev)]
        pm = torch.tensor(part, dtype=torch.float32, device=dev)
        hold("masked_u32_sum", lambda: ops.masked_u32_sum(rows, pm),
             lambda: ops.masked_u32_sum(rows, pm, impl="ref"), f"C={C} N={n} part={part}")
        if n == n_pad:
            mrows, mpm = rows, pm
    measure("masked_u32_sum", lambda: ops.masked_u32_sum(mrows, mpm),
            lambda: ops.masked_u32_sum(mrows, mpm, impl="ref"), masked_bound_ms([1, 0, 1], n_pad),
            "masked_sum_kernel")
    return stats


def phase7(dev, card: str) -> dict:
    """The uplink modes at full width: (a) aggregate on the card against the
    host, (b) the launcher's path per mode. -> main-path launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.core import packing, rounds
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.kernels import mask as kmask
    from repro_torch.kernels import pack, quant4
    from repro_torch.launch import train
    from repro_torch.models import yolov3
    from repro_torch.models.params import map_tree
    from repro_torch.optim import sgd

    cfg = get_arch("fedyolov3")
    torch.cuda.reset_peak_memory_stats()

    # -- (a) one realistic buffer: the dispatch plus one local step each
    fed = FedConfig(n_clients=4, aggregation="dense")
    state = rounds.make_state(cfg, fed, sgd(1e-3), torch.Generator().manual_seed(0), dev)
    x0 = state["params"].clone()
    agg = rounds.make_aggregator(cfg, fed)
    spec, tpl = agg.ctx.spec, agg.ctx.template
    batch = rounds.to_device(next(detection_suite(cfg, fed, batch=2, img_size=64, pool_scenes=24)[0]),
                             dev)
    opt = sgd(1e-3)
    ost = opt.init(state["params"])
    for c in range(4):
        row = state["params"][c]
        flat = row.detach().requires_grad_(True)
        loss, _ = yolov3.yolo_loss(packing.unpack_views(spec, flat, tpl),
                                   map_tree(lambda t: t[c, 0], batch), cfg)
        (grad,) = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            opt.update(row, grad, {k: v[c] for k, v in ost.items()})
    x = state["params"].detach().clone()
    N = x.shape[1]
    print(f"phase7a buffer (4, {N}): dispatch + one sgd step per client, |delta| max "
          f"{float((x - x0).abs().max()):.3e}  [{card}]", flush=True)

    def operands(C, where):
        mask = torch.tensor([1.0, 0.0] + [1.0] * (C - 2), device=where)
        w = mask / mask.sum()
        return x[:C].to(where), x0[:C].to(where), w, mask

    def run(mode, kw, where):
        C = kw.get("n_clients", 3)
        f = FedConfig(aggregation=mode, agg_impl="kernel", **{"n_clients": C, **kw})
        a = rounds.make_aggregator(cfg, f)
        xs, x0s, w, mask = operands(C, where)
        t0 = time.perf_counter()
        out, st = a.aggregate(xs.clone(), w, a.init_state(x0s), mask)
        torch.cuda.synchronize()
        return a, out, st, time.perf_counter() - t0

    def leaves(st, prefix=""):
        for k, v in sorted(st.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            elif isinstance(v, torch.Tensor):
                yield prefix + k, v

    for mode, kw in UPLINK_EXACT + UPLINK_TOL:
        _, out_c, st_c, tc = run(mode, kw, dev)
        _, out_h, st_h, th = run(mode, kw, torch.device("cpu"))
        pairs = [("out", out_c.cpu(), out_h)] + [
            (k, a.cpu(), b) for (k, a), (_, b) in zip(leaves(st_c), leaves(st_h))]
        check(all(torch.isfinite(a).all() for _, a, _ in pairs if a.is_floating_point()),
              f"{mode}: non-finite aggregate")
        gap = max(float((a.double() - b.double()).abs().max()) for _, a, b in pairs)
        if (mode, kw) in UPLINK_EXACT:
            for name, a, b in pairs:
                check(same_bits(a, b), f"{mode}: card {name} != host {name} (max gap {gap:.3e})")
            held = "bitwise-equal"
        else:
            for name, a, b in pairs:
                check(torch.allclose(a, b, rtol=1e-6, atol=1e-8),
                      f"{mode}: card {name} != host {name} at rtol 1e-6 / atol 1e-8 (gap {gap:.3e})")
            held = "rtol 1e-6 / atol 1e-8"
        print(f"phase7a {mode:12s} {kw}: card == host ({held}; max abs gap {gap:.3e}); "
              f"card {tc * 1e3:.1f} ms host {th * 1e3:.1f} ms  [{card}]", flush=True)

    # the two invariants, on the card
    outs = [run("secure", dict(secure_domain="int8", secure_mask=m, secure_session=2), dev)[1]
            for m in (True, False)]
    check(same_bits(outs[0], outs[1]), "secure: masked != unmasked on the card")
    a = run("topk_ef", dict(topk_frac=0.1), dev)[0]
    xs, x0s, _, _ = operands(3, dev)
    acc, sel, up, residual = a.split(xs, a.init_state(x0s))
    check(same_bits(torch.where(sel, acc, residual), acc), "topk_ef: uploaded + residual != acc")
    check(same_bits(residual, torch.where(sel, 0.0, acc)), "topk_ef: residual != unselected acc")
    print(f"phase7a secure masked == unmasked bitwise; topk_ef uploaded + residual == acc bitwise "
          f"({int(sel.sum())} of {sel.numel()} selected)  [{card}]", flush=True)
    x_host, x0_host = x.cpu(), x0.cpu()  # phase 11b's buffer
    del state, ost, x, x0, batch, outs, acc, sel, up, residual
    print(f"phase7a peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB  [{card}]",
          flush=True)

    # -- (b) the launcher's path per mode
    counters = {"quant8_reduce": pack.quant8_reduce, "quant4_reduce": quant4.quant4_reduce,
                "masked_u32_sum": kmask.masked_u32_sum, "grouped_reduce": pack.grouped_reduce,
                "packed_bucket_reduce": pack.packed_bucket_reduce,
                "quantize_rows": pack.quantize_rows, "dequantize_rows": pack.dequantize_rows}
    # K5b has no caller on any round's path: counted, and held at 0
    main_launches = {"dequantize_rows": 0}
    for mode, (extra, per_round) in UPLINK_RUNS.items():
        args = train.build_parser().parse_args([
            "--task", "detection", "--full-size", "--device", str(dev), "--img-size", str(IMG),
            "--clients", str(TRAIN_CLIENTS), "--participation", "masked", "--max-participants", "2",
            "--fairness-rounds", "3", "--agg", mode, "--optimizer", "sgd", "--lr", "1e-3",
            "--local-steps", "1", "--batch", str(TRAIN_BATCH), "--rounds", str(UPLINK_ROUNDS), *extra,
        ])
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        run_ = train.train_detection(args, log=lambda m: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        server = run_.server
        losses = [r.loss for r in server.history]
        check(len(losses) == UPLINK_ROUNDS and all(np.isfinite(losses)), f"{mode}: losses {losses}")
        for k, n in per_round.items():
            check(launches[k] == n * UPLINK_ROUNDS,
                  f"{mode}: {k} launched {launches[k]} times in {UPLINK_ROUNDS} rounds")
            main_launches[k] = main_launches.get(k, 0) + launches[k]
        check(launches["dequantize_rows"] == 0, f"{mode}: K5b launched {launches['dequantize_rows']} times")
        main_launches["dequantize_rows"] += launches["dequantize_rows"]
        main_launches[f"{mode}_rounds"] = UPLINK_ROUNDS
        # where a round's time goes: the round, and the aggregation alone
        gen, _, _ = detection_suite(cfg, server.fed, batch=TRAIN_BATCH, img_size=IMG, seed=1)
        nxt = next(gen)
        round_ms = time_ms(lambda: server.run_round(nxt), reps=3, warmup=1)
        C = server.fed.n_clients
        mask = torch.tensor([1.0, 0.0] + [1.0] * (C - 2), device=dev)
        scratch = server.state["params"].clone()
        agg_ms = time_ms(lambda: server.aggregator.aggregate(scratch, mask / mask.sum(),
                                                             server.state["agg"], mask), reps=10)
        print(f"phase7b {mode:8s} {' '.join(extra) or '--clients 3'}: {UPLINK_ROUNDS} rounds in "
              f"{wall:.2f} s, loss {' '.join(f'{v:.3f}' for v in losses)}; launches "
              f"{ {k: v for k, v in launches.items() if v} } (K5b {launches['dequantize_rows']}); ms "
              f"per round {round_ms:.3f}, aggregation alone {agg_ms:.3f}; peak device memory "
              f"{peak:.2f} GiB  [{card}]", flush=True)

    # -- K4's path: quant8 without a client mesh (an FLServer built directly)
    from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
    from repro_torch.core.server import FLServer

    fed = FedConfig(n_clients=TRAIN_CLIENTS, aggregation="quant8", client_axis="data",
                    data_axis=None, participation="masked", agg_impl="kernel")
    server = FLServer(cfg, fed, sgd(1e-3), device=dev, scheduler=TaskScheduler(
        TRAIN_CLIENTS, SchedulerConfig(max_participants=2, fairness_rounds=3)))
    gen, _, _ = detection_suite(cfg, fed, batch=TRAIN_BATCH, img_size=IMG)
    for fn in counters.values():
        fn.launches = 0
    server.fit(gen, UPLINK_ROUNDS, log=None)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = [r.loss for r in server.history]
    check(all(np.isfinite(losses)), f"meshless quant8: losses {losses}")
    check(launches["quant8_reduce"] == UPLINK_ROUNDS and launches["quantize_rows"] == 0
          and launches["dequantize_rows"] == 0,
          f"meshless quant8: launches {launches} in {UPLINK_ROUNDS} rounds")
    main_launches["quant8_reduce"] = launches["quant8_reduce"]
    main_launches["dequantize_rows"] += launches["dequantize_rows"]
    main_launches["quant8_meshless_rounds"] = UPLINK_ROUNDS
    print(f"phase7b quant8 without a mesh (FLServer, mesh=None): {UPLINK_ROUNDS} rounds, loss "
          f"{' '.join(f'{v:.3f}' for v in losses)}; launches "
          f"{ {k: v for k, v in launches.items() if v} } (K5b {launches['dequantize_rows']})  [{card}]",
          flush=True)
    del server
    return main_launches, (x_host, x0_host)


def lm_bounds(nbytes: float, products: float, other: float) -> dict:
    """K9's and K10's two bounds (ms) for ``nbytes`` of HBM traffic,
    ``products`` operations of f32 products and sums, and ``other`` f32
    operations (softmax, decay): "tc" with the products on the tensor cores
    through the 3xTF32 split (three tf32 products each) and the rest on the
    FP32 units, "fp32" with everything on the FP32 units (the bound of the
    kernels' earlier scalar designs, kept for comparison).
    Each is the larger of its operations' time and the bytes' time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = (3 * products / TF32_OPS_PER_S + other / F32_OPS_PER_S) * 1e3
    t_fp32 = (products + other) / F32_OPS_PER_S * 1e3
    return {"tc": (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations"),
            "fp32": (t_bytes, "bytes") if t_bytes >= t_fp32 else (t_fp32, "operations")}


def flash_bound_ms(B: int, H: int, Hkv: int, S: int, hd: int, causal: bool, window: int,
                   esize: int) -> dict:
    """K9 reads q, k and v once and writes out; per visible (query, key) pair
    2 hd operations for q.k and 2 hd for p.v (the products), and 3 for the
    softmax (subtract the max, exp, add to the row sum). Pairs outside the
    band cost nothing."""
    rel = torch.arange(S)[:, None] - torch.arange(S)[None, :]
    vis = torch.ones((S, S), dtype=torch.bool)
    if causal:
        vis &= rel >= 0
    if window:
        vis &= rel < window
    pairs = int(vis.sum()) * B * H
    return lm_bounds(esize * (2 * B * H * S * hd + 2 * B * Hkv * S * hd), pairs * 4 * hd, pairs * 3)


def ssd_bound_ms(B: int, S: int, H: int, P: int, N: int, Q: int, esize: int) -> dict:
    """K10 reads xdt, dA, Bm and Cm once and writes y, states, chunk_decay
    and exp_cum (float32). The least work: C B^T over the causal triangle
    once per (batch, chunk) (B and C have no head axis); per (batch, chunk,
    head) y (2 P per pair of the triangle) and the states (2 Q N P), the
    products; and the triangle's exp, L and G * L (3 per pair), B times the
    decay (Q N) and the cumsum and exps (3 Q)."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    products = B * nc * tri * 2 * N + B * nc * H * (tri * 2 * P + 2 * Q * N * P)
    other = B * nc * H * (tri * 3 + Q * N + 3 * Q)
    nbytes = (esize * (B * S * H * P + 2 * B * S * N) + 4 * B * S * H
              + 4 * (B * S * H * P + B * nc * H * P * N + B * nc * H + B * S * H))
    return lm_bounds(nbytes, products, other)


def tensor_core_counts(card: str) -> dict:
    """Tensor-core instructions (HMMA/HGMMA) in the SASS of every K9 and K10
    kernel, by compiling each source alone and reading it with cuobjdump;
    where the toolkit has no cuobjdump, the mma instructions of the
    sources. Fails if a kernel has none. -> {source: count over its kernels}."""
    from repro_torch.kernels import _build

    out = {}
    for src, info in _build.inspect(("flash_attention.cu", "ssd_scan.cu")).items():
        check(info["rc"] == 0, f"nvcc failed on {src}: {info['ptxas']}")
        if info["mma"] is None:
            text = "".join((_build.CSRC / f).read_text() for f in (src, "mma_tf32.cuh"))
            n = text.count("mma.sync.aligned")
            check(n > 0, f"{src}: no mma instruction in the source")
            print(f"phase8 {src}: SASS HMMA/HGMMA not measured (no cuobjdump); "
                  f"{n} mma.sync instruction(s) in its source  [{card}]", flush=True)
            out[src] = None
            continue
        for name, count in info["mma"].items():
            check(count > 0, f"{src}: {name} has no tensor-core instruction")
        kernels = "; ".join(f"{n[:n.find('>(') + 1] or n} {c}".replace("void ", "").replace("<unnamed>::", "")
                            for n, c in info["mma"].items())
        print(f"phase8 {src}: SASS HMMA/HGMMA per kernel: {kernels}  [{card}]", flush=True)
        out[src] = sum(info["mma"].values())
    return out


def phase8(dev, card: str) -> dict:
    """K9 and K10 against their plain versions on the card at the
    reference's tolerances; times and bounds at the main path's shapes.
    -> {kernel: fields}."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    hmma = tensor_core_counts(card)
    g = torch.Generator(device=dev).manual_seed(15)
    stats = {"flash_attention": {"cases": 0, "max_abs_err": 0.0, "sass_hmma": hmma["flash_attention.cu"]},
             "ssd_chunk_scan": {"cases": 0, "max_abs_err": 0.0, "sass_hmma": hmma["ssd_scan.cu"]}}

    for (B, H, Hkv, S, hd), causal, window, dt in FLASH_CASES:
        q = torch.randn((B, H, S, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, Hkv, S, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, Hkv, S, hd), generator=g, device=dev).to(dt)
        kern = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = ops.flash_attention(q, k, v, causal=causal, window=window, impl="ref")
        torch.cuda.synchronize()
        tol = KERNEL_TOL[dt]
        err = float((kern.float() - plain.float()).abs().max())
        what = f"flash_attention {(B, H, Hkv, S, hd)} causal={causal} window={window} {dt}"
        check(kern.dtype == dt and torch.allclose(kern.float(), plain.float(), rtol=tol, atol=tol),
              f"{what}: kernel != plain at {tol} (max abs err {err:.3e})")
        st = stats["flash_attention"]
        st["cases"] += 1
        if dt == torch.float32:
            st["max_abs_err"] = max(st["max_abs_err"], err)
        k_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
        bounds = flash_bound_ms(B, H, Hkv, S, hd, causal, window, q.element_size())
        (bound, by), (bound32, by32) = bounds["tc"], bounds["fp32"]
        line = (f"phase8 {what}: max abs err {err:.3e} (tol {tol}) kernel_ms={k_ms:.4f} "
                f"bound_ms={bound:.4f} ({by}, 3xTF32 tensor cores) bound_ms_fp32_units={bound32:.4f} ({by32})")
        if st["cases"] == 1:  # the qwen3 prefill's shape, float32
            st.update(ms=k_ms, bound_ms=bound, bound_by=by, bound_ms_fp32_units=bound32,
                      plain_ms=time_ms(lambda: ops.flash_attention(q, k, v, impl="ref"), reps=5, warmup=1),
                      library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=True, enable_gqa=True)))
            st["device_ms"], st["device_ms_from"] = device_ms(lambda: ops.flash_attention(q, k, v),
                                                              "flash_attention_kernel")
            sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            line += (f" device_ms={st['device_ms']} ({st['device_ms_from']}) plain_ms={st['plain_ms']:.4f} "
                     f"sdpa_ms={st['library_ms']:.4f} (yardstick only; |sdpa - kernel| max "
                     f"{float((sdpa - kern).abs().max()):.3e})")
        print(f"{line}  [{card}]", flush=True)

    for B, S, H, P, N, Q, dt in SSD_CASES:
        xdt = (torch.randn((B, S, H, P), generator=g, device=dev) * 0.1).to(dt)
        dA = -(torch.randn((B, S, H), generator=g, device=dev) * 0.1).abs()
        Bm = torch.randn((B, S, N), generator=g, device=dev).to(dt)
        Cm = torch.randn((B, S, N), generator=g, device=dev).to(dt)
        kern = ops.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=Q)
        plain = ops.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=Q, impl="ref")
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
        what = f"ssd_chunk_scan (B, S, H, P, N, Q)={(B, S, H, P, N, Q)} {dt}"
        for name, a, b in zip(("y_diag", "states", "chunk_decay", "exp_cum"), kern, plain):
            check(a.dtype == torch.float32 and torch.allclose(a, b, rtol=2e-4, atol=2e-4),
                  f"{what}: kernel {name} != plain at 2e-4 (max abs err {float((a - b).abs().max()):.3e})")
        st = stats["ssd_chunk_scan"]
        st["cases"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], max(errs))
        k_ms = time_ms(lambda: ops.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=Q))
        bounds = ssd_bound_ms(B, S, H, P, N, Q, xdt.element_size())
        (bound, by), (bound32, by32) = bounds["tc"], bounds["fp32"]
        line = (f"phase8 {what}: max abs err y/states/decay/exp_cum "
                f"{' '.join(f'{e:.3e}' for e in errs)} (tol 2e-4) kernel_ms={k_ms:.4f} "
                f"bound_ms={bound:.4f} ({by}, 3xTF32 tensor cores) bound_ms_fp32_units={bound32:.4f} ({by32})")
        if st["cases"] == 1:  # the mamba2 prefill's shape, float32
            st.update(ms=k_ms, bound_ms=bound, bound_by=by, bound_ms_fp32_units=bound32, library_ms=None,
                      plain_ms=time_ms(lambda: ops.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=Q, impl="ref"),
                                       reps=5, warmup=1))
            st["device_ms"], st["device_ms_from"] = device_ms(
                lambda: ops.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=Q), "ssd_chunk_scan_kernel")
            line += f" device_ms={st['device_ms']} ({st['device_ms_from']}) plain_ms={st['plain_ms']:.4f}"
        print(f"{line}  [{card}]", flush=True)
    return stats


def profile_lm(fn, ports: dict, card: str, tag: str, what: str, phase: str = "phase9",
               host: bool = False) -> None:
    """One profiled call of ``fn`` (a prefill, a decode step or a training
    round): device time split into the port's kernels (``ports``: label ->
    kernel-name substrings), the cuBLAS products and the rest, and the idle
    share of its wall time; with ``host`` also the launches made and the
    host-side ops that held the host longest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.device_time_total > 0), reverse=True)
    if not rows:
        print(f"{phase} {tag} {what} profile: not measured (the profiler recorded no device kernel)"
              f"  [{card}]")
        return
    fam = {**{label: 0.0 for label in ports}, "cuBLAS products": 0.0,
           "elementwise, reductions, copies": 0.0}
    for ms, _, key in rows:
        label = next((lb for lb, names in ports.items() if any(n in key for n in names)), None)
        if label is None:
            label = ("cuBLAS products"
                     if any(w in key.lower() for w in ("gemm", "cublas", "cutlass", "sm90_", "ampere_"))
                     else "elementwise, reductions, copies")
        fam[label] += ms
    total = sum(fam.values())
    for ms, cnt, key in rows[:6]:
        print(f"{phase} {tag} {what} profile {ms:9.4f} ms x{cnt:4d}  {key[:100]}", flush=True)
    if host:
        cpu = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                      if e.self_cpu_time_total > 0), reverse=True)
        for ms, cnt, key in cpu[:6]:
            print(f"{phase} {tag} {what} profile host {ms:9.3f} ms self x{cnt:6d}  {key[:80]}",
                  flush=True)
        print(f"{phase} {tag} {what} profile: {sum(r[1] for r in rows)} device kernel launches"
              f"  [{card}]", flush=True)
    print(f"{phase} {tag} profile one {what}: wall {wall_ms:.3f} ms, device kernels {total:.3f} ms "
          f"(idle share {1 - total / wall_ms:.3f}); "
          + "; ".join(f"{k} {v:.3f} ms ({v / total:.3f})" for k, v in fam.items()) + f"  [{card}]",
          flush=True)


def phase9(dev, card: str) -> dict:
    """LM serving at full width through the launcher: qwen3-1.7b (K9) and
    mamba2-1.3b (K10). -> {kernel: main-path fields}."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import serve
    from repro_torch.models import serving as MS
    from repro_torch.models.params import flatten_with_paths

    counters = {"flash_attention": kflash.flash_attention, "ssd_chunk_scan": kssd.ssd_chunk_scan}
    out = {}
    for arch, kernel in LM_ARCHS:
        cfg = get_arch(arch)
        kcfg = dataclasses.replace(cfg, attention_impl="kernel", ssm_impl="kernel")
        rcfg = dataclasses.replace(cfg, attention_impl="ref", ssm_impl="ref")
        params = serve.lm_params(kcfg, dev)
        n_params = sum(w.numel() for _, w in flatten_with_paths(params))
        flags = ["--arch", arch, "--full-size", "--batch", str(LM_BATCH), "--prompt-len",
                 str(LM_PROMPT), "--new-tokens", str(LM_NEW), "--device", str(dev)]
        args = serve.build_parser().parse_args(flags)

        # -- the launcher's path, counts read just around it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        summary = serve.serve_lm(cfg, args, dev, params=params)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(launches[kernel] == cfg.n_layers and sum(launches.values()) == cfg.n_layers,
              f"{arch}: launches {launches} in one prefill of {cfg.n_layers} layers and "
              f"{LM_NEW} decode steps")
        check(len(summary["generated"]) == LM_NEW, f"{arch}: generated {summary['generated']}")

        # -- kernel path against the plain path on the same card and weights
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
        batch = {"tokens": prompts}
        max_len = LM_PROMPT + LM_NEW
        with torch.inference_mode():
            before = counters[kernel].launches
            kl, kc = MS.prefill(kcfg, params, batch, max_len=max_len)
            check(counters[kernel].launches - before == cfg.n_layers,
                  f"{arch}: the kernel path's prefill launched {kernel} "
                  f"{counters[kernel].launches - before} times")
            rl, rc = MS.prefill(rcfg, params, batch, max_len=max_len)
            check(all(torch.isfinite(t).all() for t in (kl, rl)), f"{arch}: non-finite prefill logits")
            pre_gap = float((kl - rl).abs().max())
            check(torch.allclose(kl, rl, rtol=PREFILL_TOL, atol=PREFILL_TOL),
                  f"{arch}: kernel prefill logits != plain at {PREFILL_TOL} (gap {pre_gap:.3e})")
            # teacher forcing on the plain path's greedy tokens
            k_steps, r_steps = [kl[:, -1]], [rl[:, -1]]
            tok = rl[:, -1].argmax(-1, keepdim=True)
            dec_gap = None
            for i in range(LM_NEW):
                before = counters[kernel].launches
                kd, kc = MS.decode_step(kcfg, params, kc, tok, LM_PROMPT + i)
                check(counters[kernel].launches == before, f"{arch}: a decode step launched {kernel}")
                rd, rc = MS.decode_step(rcfg, params, rc, tok, LM_PROMPT + i)
                if i == 0:
                    dec_gap = float((kd - rd).abs().max())
                    check(torch.allclose(kd, rd, rtol=DECODE_TOL, atol=DECODE_TOL),
                          f"{arch}: first decode logits != plain at {DECODE_TOL} (gap {dec_gap:.3e})")
                k_steps.append(kd[:, -1])
                r_steps.append(rd[:, -1])
                tok = rd[:, -1].argmax(-1, keepdim=True)
            agree = decided = 0
            for ks, rs in zip(k_steps[:LM_NEW], r_steps[:LM_NEW]):
                top2 = rs.float().topk(2, dim=-1).values
                margin = top2[:, 0] - top2[:, 1]
                row_gap = (ks.float() - rs.float()).abs().amax(-1)
                same = ks.argmax(-1) == rs.argmax(-1)
                firm = margin > 2 * row_gap
                check(bool(same[firm].all()), f"{arch}: a token with a clear margin differs")
                agree += int(same.sum())
                decided += int(firm.sum())
            del kc, rc
            # -- where the time goes
            prefill_ms = time_ms(lambda: MS.prefill(kcfg, params, batch, max_len=max_len), reps=3,
                                 warmup=1)
            plain_prefill_ms = time_ms(lambda: MS.prefill(rcfg, params, batch, max_len=max_len),
                                       reps=3, warmup=1)
            _, cache = MS.prefill(kcfg, params, batch, max_len=max_len)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            tok = prompts[:, -1:]
            start.record()
            for i in range(LM_NEW):
                logits, cache = MS.decode_step(kcfg, params, cache, tok, LM_PROMPT + i)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            end.record()
            end.synchronize()
            decode_ms = start.elapsed_time(end) / LM_NEW
            del cache
            print(f"phase9 {arch} full width ({n_params} params, f32 weights) batch {LM_BATCH} prompt "
                  f"{LM_PROMPT} new {LM_NEW} through the launcher: {launches[kernel]} {kernel} launches "
                  f"(one per layer, 0 in decode); prefill logits gap {pre_gap:.3e} (tol {PREFILL_TOL}), "
                  f"first decode gap {dec_gap:.3e} (tol {DECODE_TOL}); teacher-forced tokens agree "
                  f"{agree} of {LM_NEW * LM_BATCH} ({decided} with a top-2 margin above twice the gap, "
                  f"all agree)  [{card}]", flush=True)
            print(f"phase9 {arch} prefill_ms={prefill_ms:.3f} (plain path {plain_prefill_ms:.3f}) "
                  f"decode_ms_per_token={decode_ms:.3f} decode_tokens_per_s={LM_BATCH * 1e3 / decode_ms:.2f} "
                  f"launcher_tokens_per_s={summary['tokens_per_s']} (prefill included) "
                  f"peak_device_memory_gib={peak:.2f}  [{card}]", flush=True)
            port = {f"{kernel} (port)": (f"{kernel}_kernel",)}
            profile_lm(lambda: MS.prefill(kcfg, params, batch, max_len=max_len), port, card, arch,
                       "prefill")
            _, cache = MS.prefill(kcfg, params, batch, max_len=max_len)
            profile_lm(lambda: MS.decode_step(kcfg, params, cache, prompts[:, -1:], LM_PROMPT), port,
                       card, arch, "decode step")
            del cache
        out[kernel] = {"launches": launches[kernel],
                       "main_path": f"serve --arch {arch} --full-size --batch {LM_BATCH} "
                                    f"--prompt-len {LM_PROMPT} --new-tokens {LM_NEW}"}
        del params, kl, rl, k_steps, r_steps
        torch.cuda.empty_cache()
    return out


def fedavg_bound_ms(C: int, N: int, esize: int) -> tuple[float, str]:
    """K11 reads the (C, N) leaf once and writes (N,), in its dtype (the C
    weights and den are negligible); one multiply and one add per element
    read."""
    return roofline((C + 1) * N * esize, 2 * C * N)


def phase10a(dev, card: str, largest_leaf: int) -> dict:
    """K11 against its plain version, bitwise, over the ragged cases; times
    at the main path's largest leaf with C = 2. -> K11's fields."""
    from repro_torch.kernels import fedavg as kfedavg
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(16)
    cases = 0
    for C in FEDAVG_C:
        for N in FEDAVG_N:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((C, N), generator=g, device=dev).to(dt)
                w = torch.rand(C, generator=g, device=dev)
                alt = (torch.arange(C, device=dev) % 2 == 0).float()
                for m in (torch.ones(C, device=dev), alt, torch.zeros(C, device=dev)):
                    kern = ops.fedavg_masked_mean(x, w, m)
                    plain = ops.fedavg_masked_mean(x, w, m, impl="ref")
                    torch.cuda.synchronize()
                    check(kern.dtype == dt and torch.equal(kern, plain) and
                          torch.equal(kern.view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                                      plain.view(torch.int16 if dt == torch.bfloat16 else torch.int32)),
                          f"fedavg_masked_mean C={C} N={N} {dt} mask {m.tolist()}: kernel != plain")
                    if not m.any():
                        check(not kern.float().abs().any(), "an all-zero mask must give 0")
                    cases += 1
    print(f"phase10a K11 fedavg_masked_mean: {cases} cases bitwise equal to the plain version "
          f"(C in {FEDAVG_C}, N in {FEDAVG_N}, f32 and bf16, full / alternating / all-zero masks)"
          f"  [{card}]", flush=True)
    C, N = 2, largest_leaf
    x = torch.randn((C, N), generator=g, device=dev)
    w = torch.full((C,), 0.5, device=dev)
    m = torch.ones(C, device=dev)
    wm, den = kfedavg.weighted_mask(w, m)
    k_ms = time_ms(lambda: ops.fedavg_masked_mean(x, w, m), reps=10)
    d_ms, d_from = device_ms(lambda: ops.fedavg_masked_mean(x, w, m), "fedavg_kernel")
    p_ms = time_ms(lambda: ops.fedavg_masked_mean(x, w, m, impl="ref"), reps=5, warmup=1)
    l_ms = time_ms(lambda: torch.mv(x.t(), wm) / den, reps=10)
    lib_err = float((torch.mv(x.t(), wm) / den - ops.fedavg_masked_mean(x, w, m)).abs().max())
    bound, by = fedavg_bound_ms(C, N, 4)
    print(f"phase10a K11 at the main path's largest leaf (C {C}, N {N}, f32): kernel_ms={k_ms:.4f} "
          f"device_ms={d_ms} ({d_from}) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
          f"(torch.mv(x.t(), wm) / den, "
          f"yardstick only; max |mv - kernel| {lib_err:.3e}) bound_ms={bound:.4f} ({by})  [{card}]",
          flush=True)
    del x
    return {"cases": cases, "max_abs_err": 0.0, "ms": k_ms, "device_ms": d_ms,
            "device_ms_from": d_from, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": bound, "bound_by": by}


def phase10b(dev, card: str) -> None:
    """Gradients through K9 and K10 at full width: a one-layer qwen3-1.7b and
    a one-layer mamba2-1.3b (full width, embedding and CE included), batch
    1 x GRAD_SEQ, f32, kernel branch against plain branch on the card."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T

    for arch, counter in (("qwen3-1.7b", kflash.flash_attention),
                          ("mamba2-1.3b", kssd.ssd_chunk_scan)):
        cfg = dataclasses.replace(get_arch(arch), n_layers=1)
        kcfg = dataclasses.replace(cfg, attention_impl="kernel", ssm_impl="kernel")
        rcfg = dataclasses.replace(cfg, attention_impl="ref", ssm_impl="ref")
        weights = P.init_params(T.template(cfg), torch.Generator(device=dev).manual_seed(0))
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, GRAD_SEQ))).to(dev)

        def run(c):
            p = P.map_tree(lambda w: w.clone().requires_grad_(True), weights)
            loss, _ = T.loss_fn(c, p, {"tokens": toks})
            return loss.detach(), torch.autograd.grad(loss, [w for _, w in P.flatten_with_paths(p)])

        counter.launches = 0
        lk, gk = run(kcfg)
        torch.cuda.synchronize()
        launches = counter.launches
        check(launches == 2, f"{arch}: {launches} kernel launches in one checkpointed layer's "
                             f"forward and backward (expected 2: the forward and its recompute)")
        lr, gr = run(rcfg)
        check(bool(torch.isfinite(lk)) and abs(float(lk - lr)) <= GRAD_LOSS_RTOL * abs(float(lr)),
              f"{arch}: kernel loss {float(lk)} != plain loss {float(lr)} at rtol {GRAD_LOSS_RTOL}")
        worst, scale = 0.0, 0.0
        for (path, _), a, b in zip(P.flatten_with_paths(weights), gk, gr):
            check(torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL),
                  f"{arch}: grad {path} kernel != plain at rtol {GRAD_RTOL} / atol {GRAD_ATOL} "
                  f"(max gap {float((a - b).abs().max()):.3e})")
            worst = max(worst, float((a - b).abs().max()))
            scale = max(scale, float(b.abs().max()))
        print(f"phase10b {arch} one full-width layer, batch 1 x {GRAD_SEQ}, f32: loss kernel "
              f"{float(lk)!r} plain {float(lr)!r} (rel gap {abs(float(lk - lr)) / abs(float(lr)):.3e},"
              f" tol {GRAD_LOSS_RTOL}); grads max gap {worst:.3e} (largest grad {scale:.3e}; rtol "
              f"{GRAD_RTOL} / atol {GRAD_ATOL}); {launches} launches  [{card}]", flush=True)
        del weights, gk, gr
        torch.cuda.empty_cache()


def phase10c(dev, card: str) -> None:
    """One masked adamw eq6 round of the reduced qwen3-1.7b at seq 128 (the
    K9 branch) on the card and on the host from one state, at the CPU
    tests' bounds (tests/test_torch_lm_train.py): loss rtol 1e-5; params at
    rtol 1e-4 / atol 1e-5 but for fewer than 0.05% of elements, all within
    2 E lr (adamw's sign flips near zero gradients); prev_sums rtol 1e-3."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import rounds
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data.pipeline import fed_batches
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_arch("qwen3-1.7b").reduced(), attention_impl="kernel")
    fed = FedConfig(n_clients=3, local_steps=2, aggregation="eq6", topn=1, participation="masked",
                    agg_impl="kernel")
    lr = 3e-3
    batch = next(fed_batches(cfg, fed, batch=2, seq=128))
    m = np.array([1, 0, 1], np.float32)
    host0 = rounds.make_state(cfg, fed, adamw(lr), torch.Generator().manual_seed(0), "cpu")
    out = []
    kflash.flash_attention.launches = 0
    for where in (dev, torch.device("cpu")):
        st = {k: ({kk: vv.clone().to(where) for kk, vv in v.items()} if isinstance(v, dict)
                  else v.clone().to(where) if torch.is_tensor(v) else v) for k, v in host0.items()}
        st, met = rounds.build_fed_round(cfg, fed, adamw(lr))(
            st, rounds.to_device(batch, where), rounds.participation_input(fed, m, m / m.sum()))
        out.append((float(met["loss"]), st["params"].cpu(), st["agg"]["prev_sums"].cpu()))
    (lc, pc, sc), (lh, ph, sh) = out
    launches = kflash.flash_attention.launches
    check(launches == 2 * cfg.n_layers * fed.local_steps * 2,
          f"10c: {launches} K9 launches (2 per layer per step, 2 clients, 2 steps)")
    gap = (pc - ph).abs()
    outside = gap > 1e-5 + 1e-4 * ph.abs()
    check(np.isfinite(lc) and abs(lc - lh) <= 1e-5 * abs(lh), f"10c: card loss {lc} != host {lh}")
    check(float(outside.float().mean()) < 5e-4 and float(gap.max()) <= 2 * fed.local_steps * lr,
          f"10c: {int(outside.sum())} params outside rtol 1e-4 / atol 1e-5, max gap {float(gap.max())}")
    check(torch.allclose(sc, sh, rtol=1e-3), "10c: prev_sums card != host at rtol 1e-3")
    print(f"phase10c one masked adamw eq6 round, reduced qwen3-1.7b, seq 128 ({launches} K9 launches "
          f"on the card): card loss {lc!r} host loss {lh!r} (rel gap {abs(lc - lh) / abs(lh):.3e}); "
          f"params max gap {float(gap.max()):.3e}, {int(outside.sum())} of {gap.numel()} outside "
          f"rtol 1e-4 / atol 1e-5; prev_sums max rel gap "
          f"{float(((sc - sh).abs() / sh.abs()).max()):.3e}  [{card}]", flush=True)


class _Timed:
    """Wrap ``cls.name`` for the duration of a ``with``: CUDA events around
    every call, elapsed ms appended to ``self.ms``."""

    def __init__(self, cls, name: str):
        self.cls, self.name, self.ms = cls, name, []

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.name)

        def wrapped(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **kw)
            end.record()
            end.synchronize()
            self.ms.append(start.elapsed_time(end))
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def phase10de(dev, card: str) -> dict:
    """(d) The launcher's LM training path at full width and depth for
    qwen3-1.7b and mamba2-1.3b; (e) the compression demo's tail on qwen3's
    trained state. -> launch counts and K11's main-path fields."""
    from repro_torch.core import packing
    from repro_torch.core.aggregators.eq6 import Eq6
    from repro_torch.core.server import FLServer
    from repro_torch.data.pipeline import fed_batches
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import pack
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import train

    counters = {"flash_attention": kflash.flash_attention, "ssd_chunk_scan": kssd.ssd_chunk_scan,
                "packed_bucket_reduce": pack.packed_bucket_reduce}
    out: dict = {}
    for arch, kernel in LM_ARCHS:
        args = train.build_parser().parse_args([
            "--task", "lm", "--arch", arch, "--full-size", "--clients", str(LM_TRAIN_CLIENTS),
            "--rounds", str(LM_TRAIN_ROUNDS), "--batch", str(LM_TRAIN_BATCH), "--seq",
            str(LM_TRAIN_SEQ), "--device", str(dev)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        with _Timed(FLServer, "run_round") as rt, _Timed(Eq6, "aggregate") as at:
            t0 = time.perf_counter()
            run = train.train_lm(args, log=lambda msg: print(f"phase10d {arch} {msg}", flush=True))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        server = run.server
        cfg, fed = server.cfg, server.fed
        losses = [r.loss for r in server.history]
        check(len(losses) == LM_TRAIN_ROUNDS and all(np.isfinite(losses)), f"{arch}: losses {losses}")
        steps = LM_TRAIN_ROUNDS * fed.n_clients * fed.local_steps  # full participation
        want = 2 * cfg.n_layers * steps
        check(launches[kernel] == want and sum(launches[k] for k in
                                              ("flash_attention", "ssd_chunk_scan")) == want,
              f"{arch}: {launches} in {steps} local steps of {cfg.n_layers} checkpointed layers "
              f"(expected {want} {kernel})")
        check(launches["packed_bucket_reduce"] == LM_TRAIN_ROUNDS,
              f"{arch}: K1 launched {launches['packed_bucket_reduce']} times in {LM_TRAIN_ROUNDS} rounds")
        check(peak < LM_TRAIN_PEAK_GIB, f"{arch}: peak device memory {peak:.2f} GiB "
                                        f"(limit {LM_TRAIN_PEAK_GIB})")
        n = server.state["params"].shape[1]
        print(f"phase10d {arch} full width and depth ({n} params, f32, adamw {args.lr}), "
              f"{fed.n_clients} clients x batch {args.batch} x {args.seq} tokens, eq6 top-{fed.topn}, "
              f"{LM_TRAIN_ROUNDS} rounds in {wall:.2f} s through the launcher: loss "
              f"{' '.join(repr(v) for v in losses)}; launches {launches} (expected {want} {kernel}: "
              f"2 per layer per local step with recompute, {LM_TRAIN_ROUNDS} K1)  [{card}]", flush=True)
        print(f"phase10d {arch} ms_per_round={' '.join(f'{v:.3f}' for v in rt.ms)} "
              f"aggregation_ms={' '.join(f'{v:.3f}' for v in at.ms)} peak_device_memory_gib={peak:.2f}"
              f"  [{card}]", flush=True)
        gen = fed_batches(cfg, fed, batch=args.batch, seq=args.seq, seed=1)
        before = server.state["agg"]["prev_sums"]  # the profiled round's starting sums
        profile_lm(lambda: server.run_round(next(gen)),
                   {"K9/K10 (port)": ("flash_attention_kernel", "ssd_chunk_scan_kernel"),
                    "K1 (port)": ("bucket_reduce_kernel",)}, card, arch, "round", "phase10d", host=True)
        out[kernel] = {"launches": launches[kernel],
                       "main_path": f"train --task lm --arch {arch} --full-size --clients "
                                    f"{LM_TRAIN_CLIENTS} --rounds {LM_TRAIN_ROUNDS} --batch "
                                    f"{LM_TRAIN_BATCH} --seq {LM_TRAIN_SEQ}"}
        out["packed_bucket_reduce"] = out.get("packed_bucket_reduce", 0) + launches["packed_bucket_reduce"]

        if arch == "qwen3-1.7b":  # (e) the demo's tail on this state
            out.update(phase10e(dev, card, server, before))
        del run, server, gen
        packing.bucket_ids_on.cache_clear()
        packing.bucket_ids.cache_clear()
        torch.cuda.empty_cache()
    return out


def phase10e(dev, card: str, server, before) -> dict:
    """The compression demo's tail (``repro_torch.examples.compression_demo.
    report``) on the full-width qwen3-1.7b state that phase 10d trained:
    Eq. 6 scores and uploads, one K1 launch, ``fedavg_tree`` with one K11
    launch per leaf, bitwise equal to ``impl="ref"`` on the card. The
    optimizer moments (27.5 GB at C = 2) are freed first: the tail adds the
    client-stacked copy (13.8 GB) and two aggregated trees (6.9 GB each)."""
    from repro_torch.examples import compression_demo
    from repro_torch.kernels import fedavg as kfedavg
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack
    from repro_torch.models.params import flatten_with_paths

    server.state = {**server.state, "opt": {}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, fed = server.cfg, server.fed
    pack.packed_bucket_reduce.launches = kfedavg.fedavg_masked_mean.launches = 0
    lines: list[str] = []
    t0 = time.perf_counter()
    rep = compression_demo.report(cfg, fed, before, server.state, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k11 = pack.packed_bucket_reduce.launches, kfedavg.fedavg_masked_mean.launches
    for line in "\n".join(lines).splitlines():
        print(f"phase10e demo | {line}", flush=True)
    n_leaves = len(list(flatten_with_paths(rep["stacked"])))
    check(k1 == 1, f"10e: K1 launched {k1} times in the demo's tail")
    check(k11 == n_leaves, f"10e: K11 launched {k11} times for {n_leaves} leaves")
    check(rep["masks"].any(dim=1).all(), "10e: a client uploads no bucket")
    want = ops.fedavg_tree(rep["stacked"], rep["weights"], rep["leaf_masks"], impl="ref")
    torch.cuda.synchronize()
    for (path, a), (_, b) in zip(flatten_with_paths(rep["agg"]), flatten_with_paths(want)):
        check(same_bits(a, b), f"10e: fedavg_tree leaf {path}: kernel != plain")
        check(bool(torch.isfinite(a).all()), f"10e: fedavg_tree leaf {path} not finite")
    del want
    args = (rep["stacked"], rep["weights"], rep["leaf_masks"])
    tree_ms = time_ms(lambda: ops.fedavg_tree(*args), reps=3, warmup=1)
    tree_device_ms, tree_from = device_ms(lambda: ops.fedavg_tree(*args), "fedavg_kernel", reps=1,
                                          launches=n_leaves)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    uploads = {c: rep["masks"][c].nonzero()[:, 0].tolist() for c in range(fed.n_clients)}
    print(f"phase10e demo tail on qwen3-1.7b's trained state ({n_leaves} leaves, C {fed.n_clients}): "
          f"uploads {uploads}, {rep['uploaded']} elements uploaded; K1 {k1} launch, K11 {k11} "
          f"launches, fedavg_tree bitwise equal to impl='ref' on every leaf; tail {wall:.2f} s; "
          f"fedavg_tree {tree_ms:.3f} ms (events), K11 device {tree_device_ms} ms in total "
          f"({tree_from}); peak "
          f"device memory {peak:.2f} GiB (optimizer moments freed)  [{card}]", flush=True)
    del rep, args
    return {"fedavg_masked_mean": {
        "launches": k11, "tree_ms": tree_ms, "tree_device_ms": tree_device_ms,
        "tree_device_ms_from": tree_from,
        "main_path": "examples.compression_demo.report on phase 10d's qwen3-1.7b state",
    }, "packed_bucket_reduce_demo": k1}


def rowq_bound_ms(C: int, N: int, block: int) -> tuple[float, str]:
    """K5a reads (C, N) f32 once and writes (C, N) int8 and (C, ceil(N/block))
    f32 scales; per element an abs, a max, a divide, a round and a clip. K5b
    moves the same bytes the other way with one multiply per element."""
    return roofline(C * N * 5 + C * -(-N // block) * 4, 5 * C * N)


def ties_rows() -> np.ndarray:
    """Two 256-element rows whose scale is exactly 1 (amax 127): x/s on .5
    ties (half to even decides), on +-127 and next to it."""
    halves = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)
    row0 = np.concatenate([halves, [127.0, -127.0]]).astype(np.float32)
    row1 = np.float32(127.0) * np.linspace(-1, 1, 256, dtype=np.float32)
    row1[::7] = np.nextafter(np.float32(127.0), np.float32(0.0))
    return np.stack([row0, row1])


def held_tree_past_capacity(dev, held) -> None:
    """K12b's grouped launch over a synthetic tree of more leaves than its
    table holds: f32 and bf16 outputs in turn, leaves of 0, 1, 3, 1023,
    1025, 4096 and 100,003 elements, one q 1 byte off a 16-byte boundary
    (the scalar path); one launch per TREE_CAPACITY non-empty leaves, every
    leaf bitwise equal to the plain version."""
    from repro_torch.kernels import quant as kquant
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(21)
    sizes = [1, 3, 1023, 1025, 0, 4096, 100_003]
    qs, scales, dtypes = [], [], []
    for i in range(kquant.TREE_CAPACITY * 2 + 5):
        n = sizes[i % len(sizes)]
        q = torch.randint(-127, 128, (n + 1,), generator=g, device=dev, dtype=torch.int8)
        qs.append(q[1:] if i == 9 else q[:n])  # leaf 9 (n = 1023) starts 1 byte off 16
        scales.append(torch.rand(-(-n // 1024), generator=g, device=dev) * 2.0 ** (i % 40 - 20))
        dtypes.append((torch.float32, torch.bfloat16)[i % 2])
    nonempty = sum(q.numel() > 0 for q in qs)
    before = kquant.dequantize_tree.launches
    outs = kquant.dequantize_tree(qs, scales, dtypes)
    launched = kquant.dequantize_tree.launches - before
    check(launched == -(-nonempty // kquant.TREE_CAPACITY),
          f"a tree of {nonempty} non-empty leaves took {launched} launches")
    for i, (q, sc, dt, out) in enumerate(zip(qs, scales, dtypes, outs)):
        held("dequantize", out, ref.dequantize(q, sc, kquant.TREE_BLOCK, dt),
             f"synthetic tree leaf {i} (n={q.numel()}, {dt})")


def phase11a(dev, card: str) -> dict:
    """K5a, K5b, K12a and K12b against their plain versions on the card,
    bitwise; times and bounds at the main path's shape, and K12a/K12b over
    fedyolov3's whole tree. -> {kernel: fields}."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import quant as kquant
    from repro_torch.models import yolov3
    from repro_torch.models.params import flatten_with_paths

    cfg = get_arch("fedyolov3")
    tpl = yolov3.template(cfg)
    N = sum(int(np.prod(i.shape)) for _, i in flatten_with_paths(tpl))
    g = torch.Generator(device=dev).manual_seed(17)
    stats = {k: {"cases": 0, "max_abs_err": 0.0}
             for k in ("quantize_rows", "dequantize_rows", "quantize", "dequantize")}
    held = bitwise_holder(stats)

    def rows(C, n):
        x = torch.randn((C, n), generator=g, device=dev) * 1e-3
        x[:, ::97] = 0.0
        x[0, :64] *= 1e-30
        if n >= 2048:
            x[-1, 1024:2048] = 0.0  # an all-zero block: the 1e-12 floor
        return x

    main = rows(3, N)
    ties = torch.from_numpy(ties_rows()).to(dev)
    stride_n = tile_stride_n(dev)
    cases = [(main, 1024, ""), (ties, 256, ""), (ties, 1024, "")]
    cases += [(rows(C, n), block, "") for C, n, block in ROWQ_RAGGED]
    # the whole-tile kernel's edges: the smallest launch it takes (SMs x 4
    # units) and one unit less (the generic kernel), one whole grid stride
    # (C = 1), a partial last stride and block with a row boundary inside a
    # warp's walk
    min_n = stride_n // kpack.QUANT_TILE_WARPS_PER_SM * kpack.QUANT_TILE_WARPS_PER_CTA
    cases += [(rows(1, n), 1024, "") for n in (min_n, min_n - 1024, stride_n)]
    cases += [(rows(2, stride_n + 100 * 1024 + 516), 1024, "")]
    cases += [(unaligned(rows(C, n)), block, " rows 4 bytes off 16") for C, n, block in QUANT_UNALIGNED]
    cases += [(wide_rows(C, n, g, dev), block, " wide") for C, n, block in QUANT_WIDE]
    one_leaf = kquant.dequantize.launches
    for x, block, tag in cases:
        what = f"C={x.shape[0]} N={x.shape[1]} block={block}{tag}"
        q, sc = ops.quantize_rows(x, block=block)
        qr, sr = ops.quantize_rows(x, block=block, impl="ref")
        held("quantize_rows", q, qr, what + " q")
        held("quantize_rows", sc, sr, what + " scales")
        for dt in (torch.float32, torch.bfloat16):
            held("dequantize_rows", ops.dequantize_rows(q, sc, dtype=dt, block=block),
                 ops.dequantize_rows(q, sc, dtype=dt, block=block, impl="ref"), f"{what} {dt}")
        # K12a is K5a at C = 1: one row of the case, alone (row 0 of the
        # unaligned rows starts 4 bytes off 16 too)
        q1, s1 = ops.quantize(x[0], block=block)
        qr1, sr1 = ops.quantize(x[0], block=block, impl="ref")
        held("quantize", q1, qr1, what + " row 0 q")
        held("quantize", s1, sr1, what + " row 0 scales")
        # the single-leaf decode (K5b at C = 1, kernels/quant.py::dequantize)
        # keeps its own path beside the tree's grouped launch
        for dt in (torch.float32, torch.bfloat16):
            held("dequantize", ops.dequantize(q1, s1, dtype=dt, block=block),
                 ops.dequantize(q1, s1, dtype=dt, block=block, impl="ref"), f"{what} row 0 {dt}")
    check(kquant.dequantize.launches - one_leaf == 2 * len(cases),
          f"the single-leaf decode launched {kquant.dequantize.launches - one_leaf} times for "
          f"{2 * len(cases)} calls")
    tq, ts = ops.quantize_rows(ties, block=256)
    check(float(ts[0, 0]) == 1.0 and tq[0, :4].tolist() == [-126, -126, -124, -124],
          f"ties: scale {float(ts[0, 0])}, q {tq[0, :4].tolist()} (half to even expected)")
    mq, ms_ = ops.quantize_rows(main)
    timings = {
        "quantize_rows": (lambda: ops.quantize_rows(main), lambda: ops.quantize_rows(main, impl="ref"),
                          "rowquant_tile_kernel"),
        "dequantize_rows": (lambda: ops.dequantize_rows(mq, ms_),
                            lambda: ops.dequantize_rows(mq, ms_, impl="ref"), "rowdequant_kernel"),
    }
    for name, (kern, plain, kname) in timings.items():
        st = stats[name]
        st["ms"], st["plain_ms"] = time_ms(kern), time_ms(plain, reps=5, warmup=1)
        st["device_ms"], st["device_ms_from"] = device_ms(kern, kname)
        st["bound_ms"], st["bound_by"] = rowq_bound_ms(3, N, 1024)
        st["library_ms"] = None  # no one torch call quantizes per 1024-block
        flushed = ""
        if name == "quantize_rows":
            check(st["device_ms_from"] == "profiler",
                  f"K5a's {kname} device time came from {st['device_ms_from']}, not the profiler")
            st["flushed_l2_device_ms"], src = flushed_device_ms(kern, kname)
            flushed = f" flushed_l2_device_ms={st['flushed_l2_device_ms']} ({src})"
        print(f"phase11a {name} at the quant8 round's (3, {N}), block 1024: kernel_ms={st['ms']:.4f} "
              f"device_ms={st['device_ms']} ({st['device_ms_from']}){flushed} plain_ms="
              f"{st['plain_ms']:.4f} bound_ms={st['bound_ms']:.4f} ({st['bound_by']}); "
              f"{st['cases']} cases bitwise-equal  [{card}]", flush=True)
    del main, mq, ms_, cases

    phase11a_tree(dev, card, held, stats)
    return stats


def phase11a_tree(dev, card: str, held, stats: dict) -> None:
    """K12a/K12b through ``ops.quantize_tree`` / ``dequantize_tree`` over
    fedyolov3's whole tree, K12a one launch per leaf and K12b one for the
    tree, every leaf bitwise (``held``), and K12b past its table's capacity;
    the tree times and bound go into ``stats["quantize"]`` and
    ``stats["dequantize"]``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as kquant
    from repro_torch.models import yolov3
    from repro_torch.models.params import flatten_with_paths, init_params

    tree = init_params(yolov3.template(get_arch("fedyolov3")), torch.Generator(device=dev).manual_seed(0))
    leaves = list(flatten_with_paths(tree))
    N = sum(x.numel() for _, x in leaves)
    for counter in (kquant.quantize, kquant.dequantize, kquant.dequantize_tree):
        counter.launches = 0
    qt = ops.quantize_tree(tree)
    back = ops.dequantize_tree(qt, tree)
    torch.cuda.synchronize()
    launches = {"quantize": kquant.quantize.launches, "dequantize": kquant.dequantize_tree.launches,
                "dequantize one leaf": kquant.dequantize.launches}
    check(launches == {"quantize": len(leaves), "dequantize": 1, "dequantize one leaf": 0},
          f"tree round trip over {len(leaves)} leaves launched {launches}")
    qt_ref = ops.quantize_tree(tree, impl="ref")
    back_ref = ops.dequantize_tree(qt_ref, tree, impl="ref")
    for (path, a), (_, b) in zip(flatten_with_paths(qt), flatten_with_paths(qt_ref)):
        held("quantize", a, b, f"leaf {path}")
    for (path, a), (_, b) in zip(flatten_with_paths(back), flatten_with_paths(back_ref)):
        held("dequantize", a, b, f"leaf {path}")
    err = max(float((a - x).abs().max()) for (_, a), (_, x) in zip(flatten_with_paths(back), leaves))
    held_tree_past_capacity(dev, held)
    nbytes = sum(5 * x.numel() + 4 * -(-x.numel() // 1024) for _, x in leaves)
    bound = roofline(nbytes, 5 * N)
    for name, kern, plain, kname, per_call in (
            ("quantize", lambda: ops.quantize_tree(tree), lambda: ops.quantize_tree(tree, impl="ref"),
             "rowquant_", len(leaves)),  # both quantize kernels, rowquant_tile_kernel and rowquant_kernel
            ("dequantize", lambda: ops.dequantize_tree(qt, tree),
             lambda: ops.dequantize_tree(qt, tree, impl="ref"), "treedequant_kernel", 1)):
        st = stats[name]
        st["ms"], st["plain_ms"] = time_ms(kern, reps=5), time_ms(plain, reps=3, warmup=1)
        st["device_ms"], st["device_ms_from"] = device_ms(kern, kname, reps=1 if per_call > 1 else 5,
                                                          launches=per_call)
        check(st["device_ms_from"] == "profiler",
              f"K12's {name} tree device time came from {st['device_ms_from']}, not the profiler")
        st["bound_ms"], st["bound_by"] = bound
        st["library_ms"] = None
        st["launches"] = launches[name]
        print(f"phase11a {name} (K12) over fedyolov3's tree ({len(leaves)} leaves, {N} values, "
              f"{per_call} launch{'es' if per_call > 1 else ''} a tree): tree kernel_ms="
              f"{st['ms']:.4f} device_ms={st['device_ms']} ({st['device_ms_from']}, all launches) "
              f"plain_ms={st['plain_ms']:.4f} bound_ms={st['bound_ms']:.4f} ({st['bound_by']}), "
              f"reached {st['bound_ms'] / st['device_ms']:.0%}; every leaf bitwise-equal; "
              f"round-trip max error {err:.3e}  [{card}]", flush=True)


def bitwise_holder(stats: dict):
    """-> held(name, kernel out, plain out, what): fail unless the two are
    bitwise equal (dtype, shape, bits); count the case and its max abs error
    in ``stats[name]``."""

    def held(name, k, p, what):
        torch.cuda.synchronize()
        bits = {torch.bfloat16: torch.int16, torch.int8: torch.int8}.get(k.dtype, torch.int32)
        check(k.dtype == p.dtype and k.shape == p.shape and torch.equal(k.view(bits), p.view(bits)),
              f"{name} {what}: kernel != plain")
        st = stats[name]
        st["cases"] += 1
        if k.numel():
            st["max_abs_err"] = max(st["max_abs_err"], float((k.double() - p.double()).abs().max()))

    return held


def phase11b(dev, card: str, buffer) -> None:
    """The gathered int8 transport on a 1-rank NCCL group: phase 7a's buffer,
    a client masked out; quant8 with the launcher's 1 x 1 mesh (K5a, the
    int8 and scale all-gathers, the decode-reduce) == meshless K4 on the
    card == the host's meshless plain path, bitwise; both times."""
    from repro_torch.configs import get_arch
    from repro_torch.core import rounds
    from repro_torch.core.rounds import FedConfig
    from repro_torch.kernels import pack
    from repro_torch.launch import train

    cfg = get_arch("fedyolov3")
    fed = FedConfig(n_clients=4, aggregation="quant8", client_axis="data", data_axis=None,
                    agg_impl="kernel")
    mesh = train.client_mesh(dev)
    x_host, x0_host = buffer
    x, base = x_host.to(dev), x0_host[0].to(dev)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    w = mask / mask.sum()
    runs = {}
    for tag, where, m in (("mesh", dev, mesh), ("meshless", dev, None),
                          ("host", torch.device("cpu"), None)):
        agg = rounds.make_aggregator(cfg, fed, m)
        pack.quantize_rows.launches = pack.quant8_reduce.launches = 0
        out, st = agg.aggregate(x.to(where).clone(), w.to(where), {"base": base.to(where)},
                                mask.to(where))
        if where.type == "cuda":
            torch.cuda.synchronize()
        runs[tag] = (out.cpu(), st["base"].cpu(), pack.quantize_rows.launches,
                     pack.quant8_reduce.launches, agg)
    for tag in ("meshless", "host"):
        check(same_bits(runs["mesh"][0], runs[tag][0]) and same_bits(runs["mesh"][1], runs[tag][1]),
              f"11b: quant8 on the mesh != {tag} quant8")
    check(runs["mesh"][2:4] == (1, 0) and runs["meshless"][2:4] == (0, 1),
          f"11b: launches (K5a, K4) mesh {runs['mesh'][2:4]} meshless {runs['meshless'][2:4]}")
    w_d, mask_d, st0 = w.to(dev), mask.to(dev), {"base": base}
    scratch = x.clone()
    ms = {tag: time_ms(lambda a=runs[tag][4]: a.aggregate(scratch, w_d, st0, mask_d), reps=10)
          for tag in ("mesh", "meshless")}
    print(f"phase11b quant8 aggregate on (4, {x.shape[1]}) with a client masked out: 1-rank NCCL mesh "
          f"(K5a + int8/scale all-gathers + decode-reduce) == meshless K4 == host plain, bitwise; "
          f"mesh {ms['mesh']:.3f} ms vs meshless {ms['meshless']:.3f} ms per aggregation  [{card}]",
          flush=True)


def phase11c(dev, card: str) -> dict:
    """The launcher at full width with compact participation: quant8 (K5a on
    the 1 x 1 mesh) and eq6 (K1), 3 clients, a budget of 2. -> launches."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.kernels import pack
    from repro_torch.launch import train
    from repro_torch.models import yolov3

    cfg = get_arch("fedyolov3")
    counters = {"quantize_rows": pack.quantize_rows, "quant8_reduce": pack.quant8_reduce,
                "packed_bucket_reduce": pack.packed_bucket_reduce,
                "dequantize_rows": pack.dequantize_rows}
    want = {"quant8": {"quantize_rows": 1, "quant8_reduce": 0, "dequantize_rows": 0},
            "eq6": {"packed_bucket_reduce": 1, "quantize_rows": 0, "dequantize_rows": 0}}
    out = {}
    for mode, per_round in want.items():
        args = train.build_parser().parse_args([
            "--task", "detection", "--full-size", "--device", str(dev), "--img-size", str(IMG),
            "--clients", str(TRAIN_CLIENTS), "--participation", "compact", "--max-participants",
            str(COMPACT_BUDGET), "--agg", mode, "--optimizer", "sgd", "--lr", "1e-3",
            "--local-steps", "1", "--batch", str(TRAIN_BATCH), "--rounds", str(COMPACT_ROUNDS)])
        steps = [0]
        real_loss = yolov3.yolo_loss

        def counting_loss(*a, **kw):
            steps[0] += 1
            return real_loss(*a, **kw)

        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        yolov3.yolo_loss = counting_loss
        try:
            t0 = time.perf_counter()
            run = train.train_detection(args, log=lambda m: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            yolov3.yolo_loss = real_loss
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        server = run.server
        losses = [r.loss for r in server.history]
        check(len(losses) == COMPACT_ROUNDS and all(np.isfinite(losses)), f"11c {mode}: losses {losses}")
        check(steps[0] == COMPACT_BUDGET * COMPACT_ROUNDS,
              f"11c {mode}: {steps[0]} local steps in {COMPACT_ROUNDS} rounds, not "
              f"{COMPACT_BUDGET} a round")
        check(all(len(r.participants) == COMPACT_BUDGET for r in server.history),
              f"11c {mode}: participants {[r.participants for r in server.history]}")
        for k, n in per_round.items():
            check(launches[k] == n * COMPACT_ROUNDS,
                  f"11c {mode}: {k} launched {launches[k]} times in {COMPACT_ROUNDS} rounds")
        out[mode] = launches
        gen, _, _ = detection_suite(cfg, server.fed, batch=TRAIN_BATCH, img_size=IMG, seed=1)
        nxt = next(gen)
        round_ms = time_ms(lambda: server.run_round(nxt), reps=3, warmup=1)
        mask = torch.tensor([1.0, 0.0, 1.0], device=dev)
        scratch = server.state["params"].clone()
        agg_ms = time_ms(lambda: server.aggregator.aggregate(scratch, mask / mask.sum(),
                                                             server.state["agg"], mask), reps=10)
        print(f"phase11c --agg {mode} --participation compact --clients {TRAIN_CLIENTS} "
              f"--max-participants {COMPACT_BUDGET}: {COMPACT_ROUNDS} rounds in {wall:.2f} s, loss "
              f"{' '.join(f'{v:.3f}' for v in losses)}; {steps[0]} local steps; launches "
              f"{ {k: v for k, v in launches.items() if v} } (K5b {launches['dequantize_rows']}); ms "
              f"per round {round_ms:.3f}, aggregation alone {agg_ms:.3f}; peak device memory "
              f"{peak:.2f} GiB  [{card}]", flush=True)
    return out


def phase11d(dev, card: str) -> None:
    """fedsgd at full width: one shared fedyolov3 copy trained by FLServer on
    3 clients' batches of 8 at 416 seen as one batch of 24, 3 rounds; and one
    round at img 64 on the card against the host (phase 5a's rtol 1e-4 /
    atol 1e-5)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import rounds
    from repro_torch.core.rounds import FedConfig
    from repro_torch.core.server import FLServer
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.optim import sgd

    cfg = get_arch("fedyolov3")
    fed = FedConfig(n_clients=TRAIN_CLIENTS, aggregation="fedsgd", client_axis="data",
                    data_axis=None)
    # one round on the card and on the host from one state
    batch = rounds.merge_clients(rounds.to_device(
        next(detection_suite(cfg, fed, batch=2, img_size=64, pool_scenes=24)[0]), "cpu"))
    runs = []
    for where in (dev, torch.device("cpu")):
        state = rounds.make_state(cfg, fed, sgd(1e-3), torch.Generator().manual_seed(0), where)
        state, m = rounds.build_fed_round(cfg, fed, sgd(1e-3))(
            state, rounds.to_device(batch, where), rounds.uniform_weights(TRAIN_CLIENTS))
        runs.append((float(m["loss"]), state["params"].cpu()))
    (lc, pc), (lh, ph) = runs
    gap = float((pc - ph).abs().max())
    check(np.isfinite(lc) and abs(lc - lh) <= 1e-4 * abs(lh), f"11d: card loss {lc} != host {lh}")
    check(torch.allclose(pc, ph, rtol=1e-4, atol=1e-5), f"11d: card row != host row ({gap:.3e})")
    print(f"phase11d one fedsgd round at img 64 (3 clients x batch 2 as one batch of 6): card loss "
          f"{lc!r} host loss {lh!r}; params max abs gap {gap:.3e} (held at rtol 1e-4 / atol 1e-5)"
          f"  [{card}]", flush=True)

    torch.cuda.reset_peak_memory_stats()
    server = FLServer(cfg, fed, sgd(1e-3), device=dev)
    gen, _, _ = detection_suite(cfg, fed, batch=TRAIN_BATCH, img_size=IMG)
    t0 = time.perf_counter()
    server.fit(gen, FEDSGD_ROUNDS, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [r.loss for r in server.history]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(losses)), f"11d: losses {losses}")
    check(peak < FEDSGD_PEAK_GIB, f"11d: peak device memory {peak:.2f} GiB")
    check(server.state["params"].dim() == 1 and server.state["agg"] == {}, "11d: not one shared copy")
    nxt = next(gen)
    round_ms = time_ms(lambda: server.run_round(nxt), reps=3, warmup=1)
    model = server.global_params()
    check(all(torch.isfinite(p).all() for p in model.parameters()), "11d: non-finite global model")
    print(f"phase11d fedsgd FLServer, fedyolov3 full width, {TRAIN_CLIENTS} clients x batch "
          f"{TRAIN_BATCH} at {IMG} as one batch of {TRAIN_CLIENTS * TRAIN_BATCH}: {FEDSGD_ROUNDS} "
          f"rounds in {wall:.2f} s, loss {' '.join(f'{v:.3f}' for v in losses)}; ms per round "
          f"{round_ms:.3f}; peak device memory {peak:.2f} GiB  [{card}]", flush=True)


def inflight_unchanged(eng, before: torch.Tensor, old_global: torch.Tensor, version,
                       staged: list[int]) -> int:
    """Check that a buffered flush left every row in flight as it was, bit
    for bit (a client dropped in the window: the global it was redispatched
    with) -> how many were redispatched."""
    redispatched = 0
    for c in range(eng.fed.n_clients):
        if c in staged:
            continue
        moved = eng.dispatch_version[c] != version[c]
        redispatched += int(moved)
        check(same_bits(eng.state["params"][c], old_global if moved else before[c]),
              f"phase12 the flush changed client {c}'s row in flight")
    return redispatched


def timed_flush(step) -> tuple[object, float]:
    """One flush between CUDA events -> (its record, ms)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rec = step()
    end.record()
    end.synchronize()
    return rec, start.elapsed_time(end)


def phase12a(dev, card: str) -> dict:
    """Buffered eq6 at full width: a full buffer against the sync round,
    bitwise; 6 flushes with stragglers (in-flight rows bitwise, K1 once a
    flush); the launcher's ``--mode async``. -> K1's launches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import async_engine as ae
    from repro_torch.core import rounds
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.kernels import pack
    from repro_torch.launch import train
    from repro_torch.optim import sgd

    cfg = get_arch("fedyolov3")
    fed = FedConfig(aggregation="eq6", topn=4, client_axis="data", data_axis=None, mode="async",
                    agg_impl="kernel", **ASYNC_BUFFERED)
    fed_s = dataclasses.replace(fed, mode="sync")
    timing = ae.TimingModel(uplink_spread=0.5)
    gen, _, _ = detection_suite(cfg, fed_s, batch=TRAIN_BATCH, img_size=IMG)
    batches = [next(gen) for _ in range(ASYNC_FLUSHES)]

    # a full buffer: the flush is the sync round, bit for bit
    full = ae.BufferedAsyncEngine(cfg, dataclasses.replace(fed, buffer_size=fed.n_clients),
                                  sgd(1e-3), seed=ASYNC_SEED, timing=timing, device=dev)
    state = rounds.make_state(cfg, fed_s, sgd(1e-3), rounds.seed_generator(cfg, ASYNC_SEED, dev),
                              dev)
    rec = full.step_round(batches[0])
    state, m = rounds.build_fed_round(cfg, fed_s, sgd(1e-3))(
        state, rounds.to_device(batches[0], dev), rounds.uniform_weights(fed.n_clients).to(dev))
    check(rec.staleness == [0] * fed.n_clients and rec.loss == float(m["loss"]),
          f"phase12a full-buffer flush loss {rec.loss!r} != sync round loss {float(m['loss'])!r}")
    for name, a, b in [("params", full.state["params"], state["params"])] + [
            (f"opt {k}", full.state["opt"][k], state["opt"][k]) for k in state["opt"]] + [
            (f"agg {k}", full.state["agg"][k], state["agg"][k]) for k in state["agg"]]:
        check(same_bits(a, b), f"phase12a full-buffer flush != sync round: {name}")
    print(f"phase12a full buffer (C = {fed.n_clients} of {fed.n_clients}): the flush equals "
          f"the sync round bitwise (params, opt mu, agg prev_sums, loss {rec.loss!r})  [{card}]",
          flush=True)
    del full, state

    eng = ae.BufferedAsyncEngine(cfg, fed, sgd(1e-3), seed=ASYNC_SEED, timing=timing, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pack.packed_bucket_reduce.launches = 0
    recs, ms, redispatched = [], [], 0
    for b in batches:
        before, old_global = eng.state["params"].clone(), eng.global_packed_row()
        version = eng.dispatch_version.copy()
        rec, t = timed_flush(lambda: eng.step_round(b))
        recs.append(rec)
        ms.append(t)
        redispatched += inflight_unchanged(eng, before, old_global, version, rec.participants)
        del before
    launches = pack.packed_bucket_reduce.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stal = [s for r in recs for s in r.staleness]
    dropped = sum(r.dropped for r in recs)
    check(all(np.isfinite(r.loss) for r in recs), f"phase12a losses {[r.loss for r in recs]}")
    check(launches == ASYNC_FLUSHES, f"phase12a K1 launched {launches} times in "
                                     f"{ASYNC_FLUSHES} flushes")
    check(max(stal) >= 1 and dropped >= 1 and redispatched == dropped,
          f"phase12a staleness {stal}, {dropped} dropped, {redispatched} redispatched")
    # a profile of 2 more flushes: "profiler" only when it recorded exactly
    # one bucket_reduce_kernel launch a flush
    k1_ms, k1_from = device_ms(lambda: eng.step_round(batches[0]), "bucket_reduce_kernel", reps=2)
    print(f"phase12a buffered eq6 C {fed.n_clients}, buffer {fed.buffer_size}, alpha "
          f"{fed.staleness_alpha}, max_staleness {fed.max_staleness}, uplink spread 0.5, seed "
          f"{ASYNC_SEED}: {ASYNC_FLUSHES} flushes, participants {[r.participants for r in recs]}, "
          f"staleness {[r.staleness for r in recs]}, dropped {[r.dropped for r in recs]}, sim "
          f"{[round(r.sim_time, 1) for r in recs]} s; in-flight rows bitwise across every flush; "
          f"K1 {launches} launches (a profile of 2 flushes: "
          f"{'1 bucket_reduce_kernel launch a flush, ' + f'{k1_ms:.4f} ms device' if k1_from == 'profiler' else 'not every launch recorded'}); loss "
          f"{' '.join(f'{r.loss:.3f}' for r in recs)}  [{card}]", flush=True)
    print(f"phase12a ms per flush {' '.join(f'{t:.3f}' for t in ms)} (median "
          f"{statistics.median(ms):.3f}; 2 clients trained, batch {TRAIN_BATCH} at {IMG}); peak "
          f"device memory {peak:.2f} GiB (with the check's copy of the buffer)  [{card}]",
          flush=True)
    del eng

    # the launcher's --mode async
    args = train.build_parser().parse_args([
        "--task", "detection", "--full-size", "--device", str(dev), "--img-size", str(IMG),
        "--clients", str(fed.n_clients), "--mode", "async", "--buffer-size", str(fed.buffer_size),
        "--max-staleness", str(fed.max_staleness), "--staleness-alpha", str(fed.staleness_alpha),
        "--agg", "eq6", "--topn", "4", "--optimizer", "sgd", "--lr", "1e-3",
        "--batch", str(TRAIN_BATCH), "--rounds", str(ASYNC_LAUNCHER_FLUSHES),
        "--seed", str(ASYNC_SEED)])
    pack.packed_bucket_reduce.launches = 0
    run = train.train_detection(args, log=lambda msg: print(f"phase12a {msg}", flush=True))
    torch.cuda.synchronize()
    launcher = pack.packed_bucket_reduce.launches
    summary = run.summary
    check(summary["mode"] == "async" and summary["rounds"] == ASYNC_LAUNCHER_FLUSHES
          and np.isfinite(summary["final_loss"]), f"phase12a launcher summary {summary}")
    check(launcher == ASYNC_LAUNCHER_FLUSHES, f"phase12a the launcher's K1 launched {launcher} "
                                              f"times in {ASYNC_LAUNCHER_FLUSHES} flushes")
    print(f"phase12a launcher --mode async: {json.dumps(summary)}; K1 {launcher} launches  "
          f"[{card}]", flush=True)
    return {"buffered": launches, "launcher": launcher}


def phase12b(dev, card: str) -> None:
    """Streaming dense at full width against its buffered twin from one
    seed: the event plane exactly, the global within 1e-5 relative."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import async_engine as ae
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.kernels import pack
    from repro_torch.optim import sgd

    cfg = get_arch("fedyolov3")
    fed = FedConfig(aggregation="dense", client_axis="data", data_axis=None, mode="async",
                    stream=True, agg_impl="kernel", **ASYNC_STREAM)
    opt = sgd(1e-3, momentum=0.0)
    gen, _, _ = detection_suite(cfg, dataclasses.replace(fed, mode="sync", stream=False),
                                batch=TRAIN_BATCH, img_size=IMG)
    batches = [next(gen) for _ in range(STREAM_FLUSHES)]
    shape = batches[0]["images"].shape
    check(shape == (fed.n_clients, 1, TRAIN_BATCH, IMG, IMG, 3), f"phase12b batch {shape}")
    runs = {}
    for name in ("streaming", "buffered"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = (ae.StreamingAsyncEngine if name == "streaming" else ae.BufferedAsyncEngine)(
            cfg, dataclasses.replace(fed, stream=name == "streaming"), opt, seed=0, device=dev)
        g0 = eng.global_packed_row().cpu()
        pack.packed_bucket_reduce.launches = 0
        recs, ms, globals_ = [], [], []
        for b in batches:
            rec, t = timed_flush(lambda: eng.step_round(b))
            recs.append(rec)
            ms.append(t)
            globals_.append(eng.global_packed_row().cpu())
        runs[name] = dict(recs=recs, ms=ms, globals=globals_, g0=g0,
                          peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                          k1=pack.packed_bucket_reduce.launches,
                          state=tuple(eng.state["ring" if name == "streaming" else "params"].shape))
        del eng
    st, bu = runs["streaming"], runs["buffered"]
    n = st["g0"].numel()
    check(st["state"] == (fed.max_staleness + 1, n), f"phase12b ring {st['state']}")
    check(same_bits(st["g0"], bu["g0"]), "phase12b the ring's row 0 != make_state's row 0")
    check(st["k1"] == 0 and bu["k1"] == STREAM_FLUSHES,
          f"phase12b K1 launches: streaming {st['k1']}, buffered {bu['k1']}")
    gaps = []
    for i, (a, b) in enumerate(zip(st["recs"], bu["recs"])):
        check((a.participants, a.staleness, a.dropped) == (b.participants, b.staleness, b.dropped),
              f"phase12b flush {i}: streaming's event plane != buffered's")
        check(np.isfinite(a.loss) and np.isfinite(b.loss), f"phase12b flush {i} losses")
        ga, gb = st["globals"][i].double(), bu["globals"][i].double()
        gaps.append(float((ga - gb).abs().max() / max(float(gb.abs().max()), 1e-9)))
        check(gaps[-1] < STREAM_TOL, f"phase12b flush {i}: streaming vs buffered relative gap "
                                     f"{gaps[-1]:.3e} >= {STREAM_TOL}")
    print(f"phase12b streaming dense C {fed.n_clients}, buffer {fed.buffer_size}, max_staleness "
          f"{fed.max_staleness}: ring {st['state']} ({st['state'][0] * n * 4 / 1e6:.2f} MB), batch "
          f"{shape} f32 ({batches[0]['images'].nbytes / 1e6:.1f} MB); participants "
          f"{[r.participants for r in st['recs']]}, staleness {[r.staleness for r in st['recs']]}, "
          f"dropped {[r.dropped for r in st['recs']]} == the buffered twin's; global relative gap "
          f"{' '.join(f'{g:.3e}' for g in gaps)} (held < {STREAM_TOL})  [{card}]", flush=True)
    for name, r in runs.items():
        print(f"phase12b {name}: ms per flush {' '.join(f'{t:.3f}' for t in r['ms'])} (median "
              f"{statistics.median(r['ms']):.3f}; 8 clients trained a flush); peak device memory "
              f"{r['peak']:.2f} GiB; K1 {r['k1']} launches  [{card}]", flush=True)


def record_arrivals(meta: dict, dev) -> tuple:
    """Drive an arrival engine through ``REPLAY_PLAN`` (each landing trained
    by the row update and sent through the codec) -> (the schedule of what
    it did, the engine)."""
    from repro_torch.core import async_engine as ae
    from repro_torch.core import rounds
    from repro_torch.core.transport import codec
    from repro_torch.core.transport import replay as rp

    eng = rp.make_engine(meta, device=dev)
    cfg = rp.build_cfg(meta)
    update = ae.build_row_update(cfg, rp.build_fed(meta), rp.build_optimizer(meta))
    events = []
    for kind, c, *rest in REPLAY_PLAN:
        if kind == "dispatch":
            (t,) = rest
            eng.clock.advance_to(max(t, eng.clock.now()))
            events.append(rp.WireEvent("dispatch", t, c, eng.dispatch(c)))
            continue
        seq, t = rest
        version, base = int(eng.dispatch_version[c]), eng.dispatch_row(c)
        trained, loss = update(torch.from_numpy(base).to(dev),
                               rounds.to_device(rp.synth_client_batch(cfg, meta, c, seq), dev))
        landed = codec.decode_update(codec.encode_update(trained.cpu().numpy(), base,
                                                         meta["wire_codec"], meta["quant_block"]),
                                     base)
        res = eng.land(c, landed, loss=float(loss), t=t)
        events.append(rp.WireEvent("land", t, c, version, seq=seq, dropped=res.dropped,
                                   flush=-1 if res.flush is None else res.flush.round_idx))
    return rp.ArrivalSchedule(meta, events), eng


def phase12c(dev, card: str) -> dict:
    """The arrival engine and the replay on the reduced qwen3 under dense
    and quant8: the replay's global against the recorded run's (bitwise /
    1e-5), the snapshot round trip bitwise. -> K1's launches."""
    from repro_torch.core.transport import replay as rp
    from repro_torch.kernels import pack

    launches = {}
    for wire_codec in ("dense", "quant8"):
        meta = dict(REPLAY_META, wire_codec=wire_codec)
        pack.packed_bucket_reduce.launches = 0
        sched, eng = record_arrivals(meta, dev)
        torch.cuda.synchronize()
        recorded = pack.packed_bucket_reduce.launches
        flushes = len(eng.history)
        check(sched.n_flushes == flushes == 5 and sched.n_dropped == eng.dropped_total == 1,
              f"phase12c {wire_codec}: {sched.n_flushes} flushes, {sched.n_dropped} dropped")
        check(recorded == flushes, f"phase12c {wire_codec}: K1 launched {recorded} times in "
                                   f"{flushes} landing flushes")
        pack.packed_bucket_reduce.launches = 0
        rep = rp.replay(rp.ArrivalSchedule.from_json(sched.to_json()), device=dev)
        torch.cuda.synchronize()
        replayed = pack.packed_bucket_reduce.launches
        got, want = rep.global_packed_row(), eng.global_packed_row()
        gap = float((got - want).abs().max())
        if wire_codec == "dense":
            check(same_bits(got, want), f"phase12c dense replay != recorded global: gap {gap:.3e}")
        else:
            check(gap <= REPLAY_QUANT_TOL, f"phase12c quant8 replay gap {gap:.3e} > "
                                           f"{REPLAY_QUANT_TOL}")
        check([r.participants for r in rep.history] == [r.participants for r in eng.history]
              and replayed == flushes, f"phase12c {wire_codec}: replay flushes or K1 launches "
                                       f"({replayed}) differ")
        # the snapshot round trip, bitwise, and both engines go on alike
        snap = eng.export_state()
        back = rp.make_engine(meta, device=dev)
        back.import_state({"arrays": snap["arrays"],
                           "scalars": json.loads(json.dumps(snap["scalars"]))})
        again = back.export_state()
        for k, v in snap["arrays"].items():
            check(v.dtype == again["arrays"][k].dtype and np.array_equal(
                v.view(np.uint8), again["arrays"][k].view(np.uint8)),
                f"phase12c export/import round trip changed {k}")
        check(same_bits(back.global_packed_row(), want), "phase12c imported global differs")
        print(f"phase12c {wire_codec}: {len(sched.events)} events recorded ({flushes} landing "
              f"flushes, {sched.n_dropped} dropped, staleness "
              f"{[r.staleness for r in eng.history]}), replayed through a fresh engine: global "
              f"max abs gap {gap:.3e} ({'bitwise' if wire_codec == 'dense' else f'held <= {REPLAY_QUANT_TOL}'}); "
              f"K1 {recorded} launches recorded, {replayed} replayed; export/import bitwise  "
              f"[{card}]", flush=True)
        launches[wire_codec] = recorded
    return launches


def wire_meta(wire_codec: str) -> dict:
    from repro_torch.core.transport import harness

    return harness.make_meta(**WIRE_META, wire_codec=wire_codec)


def median_ms(rows: list, key: str) -> float:
    vals = [r[key] for r in rows]
    return statistics.median(vals) if vals else float("nan")


def landing_split(stats) -> str:
    """The landing loop's median host ms per landing by step, a flush's
    landing apart, and per dispatch."""
    plain = [r for r in stats.landing_ms if not r["flush"]]
    flush = [r for r in stats.landing_ms if r["flush"]]
    return (f"per landing (median of {len(stats.landing_ms)}): d2h {median_ms(stats.landing_ms, 'd2h'):.1f}, "
            f"decode {median_ms(stats.landing_ms, 'decode'):.1f}, h2d {median_ms(stats.landing_ms, 'h2d'):.1f}, "
            f"land {median_ms(plain, 'land'):.2f} (no flush), land with the flush "
            f"{median_ms(flush, 'land'):.2f}; per dispatch (median of {len(stats.dispatch_ms)}): d2h "
            f"{median_ms(stats.dispatch_ms, 'd2h'):.1f}, encode {median_ms(stats.dispatch_ms, 'encode'):.1f}, "
            f"send {median_ms(stats.dispatch_ms, 'send'):.1f} ms")


def wire_replayed(res, dev, tol: float, tag: str) -> float:
    """Replay the run's recorded schedule in process on the card; hold its
    global to the run's (bitwise when ``tol`` is 0). -> the max abs gap."""
    from repro_torch.core.transport import replay as rp

    rep = rp.replay(res.schedule, device=dev)
    torch.cuda.synchronize()
    got = rep.global_packed_row().cpu()
    want = torch.from_numpy(res.global_row)
    gap = float((got - want).abs().max())
    check(torch.isfinite(got).all(), f"{tag}: non-finite replayed global")
    if tol == 0.0:
        check(same_bits(got, want), f"{tag}: replayed global != the run's, gap {gap:.3e}")
    else:
        check(gap <= tol, f"{tag}: replayed global gap {gap:.3e} > {tol}")
    check([r.participants for r in rep.history] == [r.participants for r in res.history],
          f"{tag}: replayed flushes differ")
    del rep
    return gap


def k1_at(spec, C: int, dev, card: str, tag: str, mask: torch.Tensor | None = None) -> dict:
    """K1 at a path's (C, N) with the path's own bucket ids (every row
    taking part unless ``mask`` says otherwise), bitwise against its plain
    version; its device ms beside its bound."""
    from repro_torch.core import packing
    from repro_torch.kernels import pack, ref

    n = spec.n_total
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((C, n), generator=g, device=dev)
    wm = torch.rand((C, spec.n_buckets), generator=g, device=dev)
    ids = packing.bucket_ids_on(spec, dev)
    mask = torch.ones(C, device=dev) if mask is None else mask
    kern = pack.packed_bucket_reduce(x, wm, ids, mask)
    plain = ref.packed_bucket_reduce(x, wm, ids, mask)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("num", "den"), kern, plain):
        check(same_bits(a, b), f"{tag} K1 at ({C}, {n}): kernel {name} != plain")
        err = max(err, float((a - b).abs().max()))
    del kern, plain
    dms, dfrom = device_ms(lambda: pack.packed_bucket_reduce(x, wm, ids, mask), "bucket_reduce_kernel")
    bound, by = reduce_bound_ms(C, n, spec.n_buckets)
    print(f"{tag} K1 at ({C}, {n}), {spec.n_buckets} buckets: bitwise-equal its plain version; "
          f"device {dms:.4f} ms ({dfrom}) against a {bound:.4f} ms bound ({by}; {bound / dms:.3f} "
          f"of it)  [{card}]", flush=True)
    del x, wm, ids
    torch.cuda.empty_cache()
    return {"shape": [C, n], "max_abs_err": err, "device_ms": dms, "device_ms_from": dfrom,
            "bound_ms": bound, "bound_by": by}


def phase13a(dev, card: str) -> dict:
    """The socket runs of ``WIRE_13A`` at qwen3-1.7b's full width (2
    layers): 3 flushes each from 2 worker processes of 2 clients each, K1
    once a flush in the server, the recorded schedule replayed on the card
    to the run's global (bitwise where the tolerance is 0); then K1 at a
    flush's shape against its plain version, bitwise. -> K1's launches,
    its error and device time there, and the runs' readings."""
    from repro_torch.configs import get_arch
    from repro_torch.core import packing
    from repro_torch.core.transport import codec, harness, wire
    from repro_torch.core.transport import replay as rp
    from repro_torch.kernels import pack
    from repro_torch.models import transformer as T

    torch.cuda.empty_cache()  # the worker processes need what earlier phases cached
    cfg = rp.build_cfg(wire_meta("dense"))
    spec = packing.build_pack_spec(cfg, T.template(cfg))
    n = spec.n_total
    base = get_arch("qwen3-1.7b")
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size)
          == (base.d_model, base.n_heads, base.n_kv_heads, base.d_ff, base.vocab_size)
          and cfg.n_layers == 2, "phase13 meta is not qwen3-1.7b's full width at 2 layers")
    frame = wire.HEADER_BYTES + 1 + 8 + codec.payload_bytes(n, "dense")
    check(frame <= wire.MAX_FRAME, f"phase13 dispatch frame {frame} > MAX_FRAME")
    print(f"phase13a N={n} (qwen3-1.7b, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, 2 layers); a dispatch frame is {frame} bytes "
          f"of MAX_FRAME {wire.MAX_FRAME} ({frame / wire.MAX_FRAME:.3f}); quant8 update "
          f"{codec.payload_bytes(n, 'quant8')} bytes  [{card}]", flush=True)
    out = {"n": n, "runs": {}}
    for wire_codec, tol in WIRE_13A:
        meta = wire_meta(wire_codec)
        torch.cuda.reset_peak_memory_stats()
        pack.packed_bucket_reduce.launches = 0
        t0 = time.perf_counter()
        res = harness.wire_run(meta, WIRE_FLUSHES, worker_groups=WIRE_GROUPS,
                               deadline_s=WIRE_DEADLINE_S, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = pack.packed_bucket_reduce.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        st = res.stats
        check(not st.deadline_hit and st.flushes == WIRE_FLUSHES,
              f"phase13a {wire_codec}: {st.flushes} flushes, deadline hit {st.deadline_hit}: "
              f"{res.worker_stderr}")
        check(launches == st.flushes, f"phase13a {wire_codec}: K1 launched {launches} times in "
                                      f"{st.flushes} flushes")
        check(np.isfinite(res.global_row).all() and res.global_row.shape == (n,),
              f"phase13a {wire_codec}: bad global row")
        gap = wire_replayed(res, dev, tol, f"phase13a {wire_codec}")
        lands = st.landed + res.dropped_total
        print(f"phase13a {wire_codec}: {st.flushes} flushes in {secs:.2f} s ({lands / secs:.4f} "
              f"landings/s), {st.landed} landed, {res.dropped_total} dropped, bytes up {st.bytes_up} "
              f"(an update's payload {codec.payload_bytes(n, wire_codec)}; uploads in flight at the "
              f"end count too), down {st.bytes_down}, losses "
              f"{[round(r.loss, 4) for r in res.history]}; K1 {launches} launches; replayed on the "
              f"card: global gap {gap:.3e} ({'bitwise' if tol == 0 else f'held <= {tol}'}); server "
              f"peak device memory {peak:.2f} GiB  [{card}]", flush=True)
        print(f"phase13a {wire_codec} landing loop host ms: {landing_split(st)}  [{card}]",
              flush=True)
        out["runs"][wire_codec] = {"launches": launches, "seconds": secs, "landings": lands,
                                   "bytes_up": st.bytes_up}
        del res
    # K1 at the flush's shape, 4 rows of N with the run's bucket ids and the
    # staged pair weighted, bitwise against its plain version
    out.update(k1_at(spec, 4, dev, card, "phase13a",
                     mask=torch.tensor([1.0, 1.0, 0.0, 0.0], device=dev)))
    return out


def phase13b(dev, card: str) -> int:
    """The dense socket run at full width, snapshotted after 4 landings,
    its server killed after 5 and restored from the snapshot and the WAL on
    the same port, 3 flushes; the WAL's schedule replays to the recovered
    run's global bitwise. -> K1's server-side launches."""
    import shutil
    import tempfile

    from repro_torch.core.transport import codec, harness
    from repro_torch.kernels import pack

    root = Path(tempfile.mkdtemp(prefix="fedwire_durable_"))
    try:
        pack.packed_bucket_reduce.launches = 0
        t0 = time.perf_counter()
        res = harness.wire_run(wire_meta("dense"), WIRE_FLUSHES,
                               worker_groups=[dict(g, extra=g["extra"] + WIRE_PATIENT)
                                              for g in WIRE_GROUPS],
                               deadline_s=WIRE_DEADLINE_S, durable_root=root / "run",
                               snapshot_every=WIRE_SNAPSHOT_EVERY, fault_plan=WIRE_KILL,
                               device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = pack.packed_bucket_reduce.launches
        st = res.stats
        check(not st.deadline_hit and st.flushes == WIRE_FLUSHES,
              f"phase13b: {st.flushes} flushes, deadline hit {st.deadline_hit}: {res.worker_stderr}")
        check(res.recovered and st.crashed and st.recoveries == 1,
              f"phase13b: recovered {res.recovered}, crashed {st.crashed}, "
              f"recoveries {st.recoveries}")
        # the recovery's replay of the WAL past the snapshot flushes again
        pre = res.pre_crash_stats.wal_events
        refl = sum(1 for e in res.schedule.events[pre - res.events_replayed: pre] if e.flush >= 0)
        check(launches == WIRE_FLUSHES + refl, f"phase13b: K1 launched {launches} times in "
                                               f"{WIRE_FLUSHES} flushes and {refl} replayed in "
                                               f"the recovery")
        gap = wire_replayed(res, dev, 0.0, "phase13b")
        snaps = "; ".join(f"{s['bytes']} bytes in {s['ms'] / 1e3:.2f} s" for s in st.snapshot_ms)
        print(f"phase13b {WIRE_KILL} and restore: {st.flushes} flushes in {secs:.2f} s, {st.landed} "
              f"landed; snapshots: {snaps}; recovery {res.recovery_s:.2f} s replaying "
              f"{res.events_replayed} WAL events past the snapshot ({refl} flushes; "
              f"{st.wal_events} events journaled); K1 {launches} launches; the WAL's schedule "
              f"replayed on the card: gap "
              f"{gap:.3e} (bitwise)  [{card}]", flush=True)
        print(f"phase13b dense: bytes up {st.bytes_up} (an update's payload "
              f"{codec.payload_bytes(res.global_row.size, 'dense')}), down {st.bytes_down}, "
              f"{(st.landed + res.dropped_total) / secs:.4f} landings/s; landing loop host ms: "
              f"{landing_split(st)}  [{card}]", flush=True)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase13c(dev, card: str) -> None:
    """The launcher's socket path at the reduced size: a quant8 run that
    records its schedule, the replay of it, a durable run killed at 5
    landings, and the restore; each exits cleanly with the reference's
    keys."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    root = Path(tempfile.mkdtemp(prefix="fedwire_launcher_"))
    common = ["--arch", "qwen3-1.7b", "--mode", "async", "--transport", "socket", "--clients", "4",
              "--buffer-size", "2", "--max-staleness", "2", "--batch", "2", "--seq", "16"]
    try:
        t0 = time.perf_counter()
        run = train.main([*common, "--rounds", "3", "--wire-codec", "quant8",
                          "--record-schedule", str(root / "run.schedule.json")])
        rep = train.main(["--replay-schedule", str(root / "run.schedule.json")])
        kill = train.main([*common, "--rounds", "4", "--durable-dir", str(root / "durable"),
                           "--snapshot-every", "2", "--fault-plan", "kill@5"])
        back = train.main(["--restore", str(root / "durable")])
        secs = time.perf_counter() - t0
        check(run["rounds"] == 3 and not run["deadline_hit"] and set(run) >= set(WIRE_RUN_KEYS),
              f"phase13c socket run: {run}")
        check(rep["flushes"] == 3 and rep["deterministic"]
              and abs(rep["final_loss"] - run["final_loss"]) <= 1e-5 * abs(run["final_loss"]),
              f"phase13c replay: {rep} against {run}")
        check(kill["recovered"] and kill["rounds"] == 4 and not kill["deadline_hit"],
              f"phase13c durable run: {kill}")
        check(back["version"] == 4 and set(back) >= set(WIRE_RESTORE_KEYS),
              f"phase13c restore: {back}")
        print(f"phase13c launcher (reduced qwen3-1.7b, 4 clients, one worker process): socket "
              f"quant8 3 flushes, {run['landed']} landed, bytes up {run['bytes_up']}; replayed "
              f"deterministically; kill@5 recovered ({kill['snapshots']} snapshots, "
              f"{kill['wal_events']} WAL events); restore at version {back['version']} replaying "
              f"{back['events_replayed']} events; {secs:.2f} s in all  [{card}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def platform_lm_cfg():
    """qwen3-1.7b at its published widths, its depth cut to 2 layers."""
    import dataclasses

    from repro_torch.configs import get_arch

    base = get_arch("qwen3-1.7b")
    return dataclasses.replace(base, n_layers=PLATFORM_LM_LAYERS)


def prefixed(tag: str):
    """A log that prints every line of a message behind ``tag``."""
    def log(msg: str) -> None:
        for line in str(msg).strip("\n").splitlines() or [""]:
            print(f"{tag} {line}", flush=True)

    return log


def phase14a(dev, card: str) -> dict:
    """The multi-task platform at full width through
    ``examples.multi_task_platform.run_platform``; then K1 at both tasks'
    shapes. -> K1's launches, its two shapes' readings, and the trained
    detector (for 14c)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import explorer, monitor
    from repro_torch.core.task_manager import TaskStatus
    from repro_torch.examples import multi_task_platform as mtp
    from repro_torch.kernels import flash_attention, pack

    torch.cuda.empty_cache()
    lm_cfg, ycfg = platform_lm_cfg(), get_arch("fedyolov3")
    ms: dict[str, list[float]] = {"lm": [], "yolo": []}

    def timer(tid, run):
        rec, t = timed_flush(run)
        ms[tid].append(t)
        return rec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pack.packed_bucket_reduce.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = mtp.run_platform(lm_cfg, ycfg, device=dev, lm_batch=PLATFORM_LM_BATCH, seq=PLATFORM_SEQ,
                           yolo_batch=TRAIN_BATCH, img_size=IMG, lm_rounds=PLATFORM_LM_ROUNDS,
                           yolo_rounds=PLATFORM_YOLO_ROUNDS, timer=timer, log=prefixed("phase14a"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, k9 = pack.packed_bucket_reduce.launches, flash_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    lm, yolo = out["servers"]["lm"], out["servers"]["yolo"]
    n_lm, n_yolo = lm.aggregator.ctx.spec.n_total, yolo.aggregator.ctx.spec.n_total
    check(n_yolo == 13_312_864 and lm_cfg.d_model == 2048 and lm_cfg.vocab_size == 151_936,
          f"phase14a shapes: N {n_lm} and {n_yolo}")
    check(out["passes"] == PLATFORM_PASSES, f"phase14a {out['passes']} passes")
    check(all(t.status == TaskStatus.DONE for t in out["tm"].tasks.values()),
          f"phase14a statuses {[t.status for t in out['tm'].tasks.values()]}")
    check(len(lm.history) == PLATFORM_LM_ROUNDS and len(yolo.history) == PLATFORM_YOLO_ROUNDS,
          f"phase14a rounds {len(lm.history)} and {len(yolo.history)}")
    check(all(np.isfinite(r.loss) for r in lm.history + yolo.history), "phase14a a loss is not finite")
    rounds_run = PLATFORM_LM_ROUNDS + PLATFORM_YOLO_ROUNDS
    check(launches == rounds_run, f"phase14a K1 launched {launches} times in {rounds_run} rounds")
    check(out["secure_err"] <= PLATFORM_SECURE_TOL,
          f"phase14a secure aggregation gap {out['secure_err']:.3e} > {PLATFORM_SECURE_TOL}")
    check(peak <= PLATFORM_PEAK_GIB, f"phase14a peak device memory {peak:.2f} GiB")
    for tid, srv in out["servers"].items():
        feed = json.loads(monitor.export_json(tid, srv.history, srv.fed.n_clients))
        check([r["round"] for r in feed["rounds"]] == list(range(len(srv.history)))
              and feed["n_clients"] == srv.fed.n_clients, f"phase14a export_json {tid}")
        print(f"phase14a export_json {tid}: {json.dumps(feed)}", flush=True)
    print(f"phase14a explorer.monitor(): {explorer.monitor()}", flush=True)
    print(f"phase14a qwen3-1.7b 2 layers (N = {n_lm}; attention_impl {lm_cfg.attention_impl!r}: "
          f"K9 {k9} launches) eq6 C 3 adamw and fedyolov3 (N = {n_yolo}) dense C 2 sgd at {IMG}: "
          f"{out['passes']} passes in {secs:.2f} s, drops {out['drops']}; K1 {launches} launches in "
          f"{rounds_run} rounds; secure gap {out['secure_err']:.3e}; peak device memory "
          f"{peak:.2f} GiB  [{card}]", flush=True)
    for tid in ("lm", "yolo"):
        print(f"phase14a ms per round {tid}: {' '.join(f'{t:.3f}' for t in ms[tid])} (median "
              f"{statistics.median(ms[tid]):.3f})  [{card}]", flush=True)
    model = yolo.global_params()
    lm_spec, yolo_spec = lm.aggregator.ctx.spec, yolo.aggregator.ctx.spec
    del out, lm, yolo
    torch.cuda.empty_cache()
    shapes = [k1_at(yolo_spec, 2, dev, card, "phase14a"), k1_at(lm_spec, 3, dev, card, "phase14a")]
    return {"launches": launches, "shapes": shapes, "model": model, "version": PLATFORM_YOLO_ROUNDS,
            "seconds": secs, "peak_gib": peak}


def phase14b(dev, card: str) -> int:
    """One SimClock shared by a sync detector and an async LM under
    ``TaskManager(clock=).run_to_completion``'s steps. -> K1's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core.rounds import FedConfig
    from repro_torch.core.server import FLServer
    from repro_torch.core.simclock import SimClock
    from repro_torch.core.task_manager import FederatedTask, TaskManager
    from repro_torch.data.pipeline import fed_batches
    from repro_torch.kernels import pack
    from repro_torch.optim import adamw, sgd

    torch.cuda.empty_cache()
    lm_cfg, ycfg = platform_lm_cfg(), get_arch("fedyolov3")
    common = dict(local_steps=1, client_axis="data", data_axis=None, agg_impl="kernel")
    yfed = FedConfig(n_clients=2, aggregation="dense", **common)
    lfed = FedConfig(n_clients=3, aggregation="eq6", topn=2, mode="async", buffer_size=2, **common)
    clock = SimClock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ysrv = FLServer(ycfg, yfed, sgd(1e-3), seed=0, device=dev, clock=clock, task_id="fedyolov3")
    lsrv = FLServer(lm_cfg, lfed, adamw(3e-3), seed=0, device=dev, clock=clock, task_id="qwen3-1.7b")
    check(lsrv.engine.clock is clock and ysrv.clock is clock, "phase14b the clock is not shared")
    ygen = fed_batches(ycfg, yfed, batch=TRAIN_BATCH, seq=0, img_size=IMG)
    lgen = fed_batches(lm_cfg, lfed, batch=PLATFORM_LM_BATCH, seq=PLATFORM_SEQ)
    tm = TaskManager(clock=clock)
    tm.register(FederatedTask("yolo", "fedyolov3", CLOCK_SYNC_ROUNDS,
                              lambda r: vars(ysrv.run_round(next(ygen))), next_time=ysrv.next_time))
    tm.register(FederatedTask("lm", "qwen3-1.7b", CLOCK_FLUSHES,
                              lambda r: vars(lsrv.run_async(next(lgen))), next_time=lsrv.next_time))
    pack.packed_bucket_reduce.launches = 0
    steps = []
    t0 = time.perf_counter()
    while tm.runnable():  # run_to_completion's loop, one step at a time, checked
        want = min(tm.runnable(), key=lambda t: (t.next_time(), t.task_id))
        eta, before, load_t = want.next_time(), clock.now(), ysrv.load_model.t
        ran, step_ms = timed_flush(tm.step_shared_clock)
        check(list(ran) == [want.task_id] and "error" not in ran[want.task_id],
              f"phase14b step ran {ran} where {want.task_id} had the least (next_time, task_id)")
        check(clock.now() >= before, f"phase14b the clock went back: {before} -> {clock.now()}")
        if want.task_id == "yolo":  # the round's span moves the clock and its load model
            span, lspan = clock.now() - before, ysrv.load_model.t - load_t
            check(span > 0 and abs(span - lspan) <= 1e-9 * clock.now(),
                  f"phase14b a sync round moved the clock by {span} and its load model by {lspan}")
        steps.append((want.task_id, round(eta, 3), round(clock.now(), 3), round(step_ms, 3)))
    secs = time.perf_counter() - t0
    launches = pack.packed_bucket_reduce.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    sim = [r.sim_time for r in lsrv.history]
    check(len(ysrv.history) == CLOCK_SYNC_ROUNDS and len(lsrv.history) == CLOCK_FLUSHES,
          f"phase14b {len(ysrv.history)} rounds and {len(lsrv.history)} flushes")
    check(sim == sorted(sim) and sim[-1] <= clock.now(), f"phase14b flush sim_time {sim}")
    check(len({s[0] for s in steps}) == 2, f"phase14b steps {steps}")
    check(launches == CLOCK_SYNC_ROUNDS + CLOCK_FLUSHES,
          f"phase14b K1 launched {launches} times in {CLOCK_SYNC_ROUNDS + CLOCK_FLUSHES} steps")
    check(all(np.isfinite(r.loss) for r in ysrv.history + lsrv.history), "phase14b a loss")
    check(peak <= PLATFORM_PEAK_GIB, f"phase14b peak device memory {peak:.2f} GiB")
    tm.register(FederatedTask("untimed", "x", 1, lambda r: {}))
    try:
        tm.step_shared_clock()
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    check("next_time" in refused, f"phase14b an untimed task was not refused: {refused!r}")
    print(f"phase14b one SimClock, sync fedyolov3 (dense C 2, {CLOCK_SYNC_ROUNDS} rounds) and async "
          f"qwen3-1.7b 2 layers (buffered eq6 C 3, buffer 2, {CLOCK_FLUSHES} flushes): steps "
          f"(task, its next_time, clock after, ms) {steps}; flush sim_time {[round(t, 3) for t in sim]}; "
          f"K1 {launches} launches; the untimed task refused; {secs:.2f} s; peak device memory "
          f"{peak:.2f} GiB  [{card}]", flush=True)
    del tm, ysrv, lsrv
    torch.cuda.empty_cache()
    return launches


def phase14c(dev, card: str, model, version: int) -> int:
    """14a's trained detector behind ``InferenceService``: 16 requests, none
    dropped, K3 once a served batch, the serving view. -> K3's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import monitor, serving
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import detect

    cfg, fed = get_arch("fedyolov3"), FedConfig(n_clients=1)
    imgs, _ = synthetic.scene_images(np.random.default_rng(11), PLATFORM_REQUESTS, IMG,
                                     cfg.vocab_size)
    slot = serving.ModelSlot()
    slot.publish(version, model)
    svc = serving.InferenceService(cfg, fed, slot, img_size=IMG, device=dev).start()
    results, errors = {}, []

    def client_loop(c: int) -> None:
        try:
            with serving.InferenceClient(svc.host, svc.port, timeout=300.0) as cl:
                for i in range(c, PLATFORM_REQUESTS, 2):
                    results[i] = cl.infer(imgs[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        detect.nms_keep.launches = 0
        threads = [threading.Thread(target=client_loop, args=(c,)) for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        launches, batches = detect.nms_keep.launches, svc.stats.batches
        status = serving.model_status(slot, version, slot.now(), fed, svc.stats)
    finally:
        svc.stop()
    check(not errors, f"phase14c client error: {errors[:1]!r}")
    check(len(results) == PLATFORM_REQUESTS and status["in_flight"] == 0,
          f"phase14c {len(results)} of {PLATFORM_REQUESTS} answered, {status['in_flight']} dropped")
    check(all(r.version == version for r in results.values()), "phase14c a RESULT's version")
    check(launches == batches >= 1, f"phase14c {launches} NMS launches for {batches} batches")
    view = monitor.render_serving("fedyolov3", status)
    check(view.splitlines()[0].startswith(f"[fedyolov3] serving round v{version}"),
          f"phase14c view {view!r}")
    prefixed("phase14c")(view)
    print(f"phase14c {PLATFORM_REQUESTS} requests, 0 dropped, {batches} batches, K3 {launches} "
          f"launches, {sum(len(r.detections) for r in results.values())} detections, version "
          f"{version}  [{card}]", flush=True)
    return launches


def phase14d(dev, card: str) -> int:
    """The quickstart on the card at the reference's defaults, 5 rounds:
    its loss falls (its own assert), K1 once a round. -> K1's launches."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import pack

    pack.packed_bucket_reduce.launches = 0
    t0 = time.perf_counter()
    out = quickstart.main(["--device", str(dev), "--rounds", str(PLATFORM_QUICKSTART_ROUNDS)],
                          log=prefixed("phase14d"))
    torch.cuda.synchronize()
    launches = pack.packed_bucket_reduce.launches
    check(launches == PLATFORM_QUICKSTART_ROUNDS,
          f"phase14d K1 launched {launches} times in {PLATFORM_QUICKSTART_ROUNDS} rounds")
    print(f"phase14d quickstart --rounds {PLATFORM_QUICKSTART_ROUNDS}: loss "
          f"{' '.join(f'{x:.4f}' for x in out['losses'])}, mean participants "
          f"{out['mean_participants']:.1f}/4; K1 {launches} launches; "
          f"{time.perf_counter() - t0:.2f} s  [{card}]", flush=True)
    return launches


def phase14(dev, card: str) -> dict:
    """Phase 14's four parts -> K1's and K3's launches and K1's shapes."""
    a = phase14a(dev, card)
    b = phase14b(dev, card)
    k3 = phase14c(dev, card, a.pop("model"), a["version"])
    d = phase14d(dev, card)
    return {"k1": {"platform": a["launches"], "shared_clock": b, "quickstart": d},
            "k1_shapes": a["shapes"], "k3": k3}


def family_cfg(arch: str, layers: int):
    """The registry's config at float32, its depth cut to ``layers`` (0: all)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def phase15(dev, card: str) -> dict:
    """Slice 7c at full width through the launcher: each of ``FAMILY_ROWS``
    served by ``serve_lm`` (K9/K10 counted exactly), then the kernel path's
    prefill against the plain path's, the first decode step on each path's
    cache, the kernel path's greedy decode teacher-forced against a full
    forward over the sequence it generated, the prefill's and a decode
    step's time and the peak memory. -> {kernel: {arch: launches}}."""
    import dataclasses

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import serve
    from repro_torch.models import serving as MS
    from repro_torch.models.params import flatten_with_paths
    from repro_torch.models.transformer import logits_fn

    counters = (kflash.flash_attention, kssd.ssd_chunk_scan)
    out = {"flash_attention": {}, "ssd_chunk_scan": {}}
    for arch, layers, B, P, k9, k10 in FAMILY_ROWS:
        t0 = time.perf_counter()
        cfg = family_cfg(arch, layers)
        kcfg = dataclasses.replace(cfg, attention_impl="kernel", ssm_impl="kernel")
        rcfg = dataclasses.replace(cfg, attention_impl="ref", ssm_impl="ref")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = serve.lm_params(kcfg, dev)
        n_params = sum(w.numel() for _, w in flatten_with_paths(params))
        args = serve.build_parser().parse_args(
            ["--arch", arch, "--full-size", "--batch", str(B), "--prompt-len", str(P),
             "--new-tokens", str(FAMILY_NEW), "--device", str(dev)])
        # -- the launcher's path, counts read just around it
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        summary = serve.serve_lm(cfg, args, dev, params=params)
        torch.cuda.synchronize()
        launches = tuple(fn.launches for fn in counters)
        check(launches == (k9, k10), f"phase15 {arch}: K9/K10 launches {launches} in one prefill "
                                     f"and {FAMILY_NEW} decode steps, want {(k9, k10)}")
        check(len(summary["generated"]) == FAMILY_NEW, f"phase15 {arch}: {summary['generated']}")

        prompts, images = serve.lm_inputs(cfg, B, P, dev)
        batch = {"tokens": prompts} if images is None else {"tokens": prompts, "images": images}
        ni = 0 if images is None else images.shape[1]
        S = ni + P
        max_len = S + FAMILY_NEW
        with torch.inference_mode():
            # -- kernel path against the plain path on the same card and weights
            before = tuple(fn.launches for fn in counters)
            kl, kc = MS.prefill(kcfg, params, batch, max_len=max_len)
            check(tuple(fn.launches - b for fn, b in zip(counters, before)) == (k9, k10),
                  f"phase15 {arch}: the kernel path's prefill launched K9/K10 "
                  f"{tuple(fn.launches - b for fn, b in zip(counters, before))} times")
            rl, rc = MS.prefill(rcfg, params, batch, max_len=max_len)
            check(bool(torch.isfinite(kl).all() and torch.isfinite(rl).all()),
                  f"phase15 {arch}: non-finite prefill logits")
            pre_gap = float((kl - rl).abs().max())
            check(torch.allclose(kl, rl, rtol=PREFILL_TOL, atol=PREFILL_TOL),
                  f"phase15 {arch}: kernel prefill logits != plain at {PREFILL_TOL} (gap {pre_gap:.3e})")
            tok = kl[:, -1].argmax(-1, keepdim=True)
            kd, kc = MS.decode_step(kcfg, params, kc, tok, S)
            rd, rc = MS.decode_step(rcfg, params, rc, tok, S)
            dec_gap = float((kd - rd).abs().max())
            check(torch.allclose(kd, rd, rtol=DECODE_TOL, atol=DECODE_TOL),
                  f"phase15 {arch}: first decode logits != plain at {DECODE_TOL} (gap {dec_gap:.3e})")
            del rc, rl, rd
            # -- the kernel path's greedy decode, timed, then held to a full
            # forward over the sequence it generated (teacher forcing)
            steps, toks = [kl[:, -1], kd[:, -1]], [tok]
            tok = kd[:, -1].argmax(-1, keepdim=True)
            before = tuple(fn.launches for fn in counters)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(1, FAMILY_NEW):
                toks.append(tok)
                kd, kc = MS.decode_step(kcfg, params, kc, tok, S + i)
                steps.append(kd[:, -1])
                tok = kd[:, -1].argmax(-1, keepdim=True)
            end.record()
            end.synchronize()
            decode_ms = start.elapsed_time(end) / (FAMILY_NEW - 1)
            check(tuple(fn.launches for fn in counters) == before, f"phase15 {arch}: decode launched K9/K10")
            del kc
            full_batch = dict(batch, tokens=torch.cat([prompts, *toks], dim=1))
            hidden, _ = MS.prefill_hidden(kcfg, params, full_batch)
            full = logits_fn(kcfg, params, hidden[:, S - 1:])
            del hidden
            step_l = torch.stack(steps, dim=1)  # (B, NEW + 1, V)
            tf_gap = float((step_l - full).abs().max())
            top2 = full.float().topk(2, dim=-1).values
            firm = (top2[..., 0] - top2[..., 1]) > 2 * (step_l - full).abs().amax(-1)
            same = step_l.argmax(-1) == full.argmax(-1)
            check(bool(same[firm].all()), f"phase15 {arch}: a teacher-forced token with a clear "
                                          f"margin differs from the full forward's")
            # GShard capacity depends on the routing group: a full forward
            # over S + n tokens routes differently from prefill + steps, so
            # under MoE only the tokens are held
            if cfg.family != "moe":
                check(tf_gap <= DECODE_TOL, f"phase15 {arch}: decode against the full forward "
                                            f"{tf_gap:.3e} > {DECODE_TOL}")
            del step_l, full, steps
            prefill_ms = time_ms(lambda: MS.prefill(kcfg, params, batch, max_len=max_len), reps=2,
                                 warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(peak <= FAMILY_PEAK_GIB, f"phase15 {arch}: peak {peak:.2f} GiB > {FAMILY_PEAK_GIB}")
        shape = f"{B} x {P}" + (f" + {ni} image tokens" if ni else "")
        print(f"phase15 {arch} ({cfg.n_layers} layers, {n_params} params, f32) batch {shape}, "
              f"{FAMILY_NEW} new, through the launcher: K9 {launches[0]} K10 {launches[1]} launches "
              f"(a prefill's; 0 in decode); prefill logits gap {pre_gap:.3e} (tol {PREFILL_TOL}), "
              f"first decode gap {dec_gap:.3e} (tol {DECODE_TOL}); teacher-forced against a full "
              f"forward: gap {tf_gap:.3e}, tokens agree {int(same.sum())} of {same.numel()} "
              f"({int(firm.sum())} with a top-2 margin above twice the gap, all agree)  [{card}]",
              flush=True)
        print(f"phase15 {arch} prefill_ms={prefill_ms:.3f} decode_ms_per_token={decode_ms:.3f} "
              f"decode_tokens_per_s={B * 1e3 / decode_ms:.2f} launcher_tokens_per_s="
              f"{summary['tokens_per_s']} (prefill included) peak_device_memory_gib={peak:.2f}; "
              f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
        out["flash_attention"][arch] = launches[0]
        if launches[1]:
            out["ssd_chunk_scan"][arch] = launches[1]
        del params, kl, kd
        torch.cuda.empty_cache()
    return out


def _lm_batch(cfg, positions: int, dev) -> dict:
    """One sequence of ``positions`` for a one-step loss: seed-0 tokens
    (llava's behind 2880 image embeddings) on ``dev``."""
    rng = np.random.default_rng(0)
    ni = cfg.n_image_tokens if cfg.modality == "vlm" else 0
    toks = rng.integers(0, cfg.vocab_size, (1, positions - ni))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if ni:
        batch["images"] = torch.from_numpy(
            (rng.standard_normal((1, ni, cfg.d_model)) * 0.1).astype(np.float32)).to(dev)
    return batch


def moe_choices(cfg, params, batch) -> list:
    """The ordered top-k experts of every token at every MoE layer, from a
    forward layer by layer (tests/test_torch_lm_families_train.py)."""
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import einsum, rms_norm

    out = []
    with torch.no_grad():
        x = T.embed_inputs(cfg, params, batch)
        for q in T.unstack(params["layers"]):
            h = x + A.attention_block(q["attn"], rms_norm(x, q["norm1"], cfg.norm_eps), cfg,
                                      window=cfg.window)
            g = rms_norm(h, q["norm2"], cfg.norm_eps)
            logits = einsum("bsd,de->bse", g, q["moe"]["router"])
            out.append(M.top_k(torch.softmax(logits, -1), cfg.experts_per_token)[1].cpu())
            x, _ = T.dense_block(cfg, q, x, cfg.window)
    return out


def phase16a(dev, card: str) -> dict:
    """Each of ``FAMILY_TRAIN_ROWS`` trained by the launcher's ``train_lm``:
    finite losses, exact K9/K10/K1 launches, the peak; ms a round, the eq6
    aggregation alone. -> {kernel: {arch: launches}}."""
    from repro_torch.core import packing
    from repro_torch.core.aggregators.eq6 import Eq6
    from repro_torch.core.server import FLServer
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import pack
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import train

    counters = {"flash_attention": kflash.flash_attention, "ssd_chunk_scan": kssd.ssd_chunk_scan,
                "packed_bucket_reduce": pack.packed_bucket_reduce}
    out: dict = {k: {} for k in counters}
    for arch, layers, seq, opt, lr, k9, k10 in FAMILY_TRAIN_ROWS:
        t0 = time.perf_counter()
        cfg = family_cfg(arch, layers)
        args = train.build_parser().parse_args([
            "--task", "lm", "--arch", arch, "--full-size", "--clients", str(FAMILY_TRAIN_CLIENTS),
            "--rounds", str(FAMILY_TRAIN_ROUNDS), "--batch", "1", "--seq", str(seq),
            "--optimizer", opt, "--lr", str(lr), "--device", str(dev)])
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        with _Timed(FLServer, "run_round") as rt, _Timed(Eq6, "aggregate") as at:
            run = train.train_lm(args, log=lambda msg: print(f"phase16a {arch} {msg}", flush=True),
                                 cfg=cfg)
            torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        server = run.server
        losses = [r.loss for r in server.history]
        steps = FAMILY_TRAIN_ROUNDS * server.fed.n_clients * server.fed.local_steps
        check(len(losses) == FAMILY_TRAIN_ROUNDS and all(np.isfinite(losses)),
              f"phase16a {arch}: losses {losses}")
        want = (k9 * steps, k10 * steps)
        check((launches["flash_attention"], launches["ssd_chunk_scan"]) == want,
              f"phase16a {arch}: {launches} in {steps} local steps (want K9 {k9 * steps}, K10 "
              f"{k10 * steps})")
        check(launches["packed_bucket_reduce"] == FAMILY_TRAIN_ROUNDS,
              f"phase16a {arch}: K1 launched {launches['packed_bucket_reduce']} times in "
              f"{FAMILY_TRAIN_ROUNDS} rounds")
        check(peak <= FAMILY_PEAK_GIB, f"phase16a {arch}: peak {peak:.2f} GiB > {FAMILY_PEAK_GIB}")
        n = server.state["params"].shape[1]
        print(f"phase16a {arch} ({cfg.n_layers} layers, {n} params, f32, {opt} {lr}), "
              f"{server.fed.n_clients} clients x 1 x {seq} positions, eq6 top-{server.fed.topn}, "
              f"through the launcher: loss {' '.join(repr(v) for v in losses)}; launches "
              f"{launches}  [{card}]", flush=True)
        print(f"phase16a {arch} ms_per_round={' '.join(f'{v:.3f}' for v in rt.ms)} "
              f"aggregation_ms={' '.join(f'{v:.3f}' for v in at.ms)} peak_device_memory_gib="
              f"{peak:.2f}; {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
        for k, v in launches.items():
            if v:
                out[k][arch] = v
        del run, server
        packing.bucket_ids_on.cache_clear()
        packing.bucket_ids.cache_clear()
        torch.cuda.empty_cache()
    return out


def phase16b(dev, card: str) -> None:
    """One masked adamw eq6 round of each new family, reduced, on the card
    and on the host from one state: phase 10c's bounds on the loss, the
    params and the trained rows the round aggregates, and the participants'
    same eq6 upload choices from the card's and the host's bucket sums (the
    ``prev_sums`` the round hands on). MoE is held where its routing is
    equal: the first step's expert choices must not flip."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import compression as comp
    from repro_torch.core import rounds
    from repro_torch.core.aggregators.eq6 import Eq6
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data.pipeline import fed_batches
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.models import params as P
    from repro_torch.optim import adamw

    lr, m = 3e-3, np.array([1, 0, 1], np.float32)
    for case, arch, kw in FAMILY_TRAIN_REDUCED:
        cfg = dataclasses.replace(get_arch(arch).reduced(), attention_impl="kernel",
                                  ssm_impl="kernel", **kw)
        fed = FedConfig(n_clients=3, local_steps=2, aggregation="eq6", topn=1,
                        participation="masked", agg_impl="kernel")
        batch = next(fed_batches(cfg, fed, batch=2, seq=128))
        host0 = rounds.make_state(cfg, fed, adamw(lr), torch.Generator().manual_seed(0), "cpu")
        flips = 0
        if cfg.family == "moe":  # the first local step of client 0 at the initial state
            tree = P.map_tree(lambda x: x[0], rounds.unpacked_params(cfg, fed, host0))
            first = {k: torch.as_tensor(v[0, 0]) for k, v in batch.items()}
            want = moe_choices(cfg, tree, first)
            got = moe_choices(cfg, P.map_tree(lambda x: x.to(dev), tree),
                              {k: v.to(dev) for k, v in first.items()})
            flips = sum(int((a != b).any(-1).sum()) for a, b in zip(want, got))
            n_tok = sum(a.shape[0] * a.shape[1] for a in want)
            check(flips == 0, f"phase16b {case}: {flips} of {n_tok} tokens route differently on "
                              f"the card")
        out, rows = [], []
        kflash.flash_attention.launches = kssd.ssd_chunk_scan.launches = 0
        real = Eq6.aggregate

        def kept(self, packed, *a, **kw):  # the trained rows the round aggregates
            rows.append(packed.to("cpu", copy=True))
            return real(self, packed, *a, **kw)

        Eq6.aggregate = kept
        try:
            for where in (dev, torch.device("cpu")):
                st = {k: ({kk: vv.clone().to(where) for kk, vv in v.items()} if isinstance(v, dict)
                          else v.clone().to(where) if torch.is_tensor(v) else v)
                      for k, v in host0.items()}
                st, met = rounds.build_fed_round(cfg, fed, adamw(lr))(
                    st, rounds.to_device(batch, where),
                    rounds.participation_input(fed, m, m / m.sum()))
                out.append((float(met["loss"]), st["params"].cpu(), st["agg"]["prev_sums"].cpu()))
        finally:
            Eq6.aggregate = real
        launches = (kflash.flash_attention.launches, kssd.ssd_chunk_scan.launches)
        (lc, pc, sc), (lh, ph, sh) = out
        attn_layers = (cfg.n_layers // cfg.shared_attn_period if cfg.family == "hybrid"
                       else 0 if not cfg.causal else cfg.n_layers)
        ssm_layers = cfg.n_layers if cfg.family == "hybrid" else 0
        steps = 2 * fed.local_steps  # 2 clients take part
        check(launches == (2 * attn_layers * steps, 2 * ssm_layers * steps),
              f"phase16b {case}: K9/K10 launches {launches} on the card")
        check(np.isfinite(lc) and np.isfinite(lh), f"phase16b {case}: losses {lc} {lh}")
        gaps = []
        for name, a, b in (("params", pc, ph), ("trained rows", *rows)):
            gap = (a - b).abs()
            outside = gap > 1e-5 + 1e-4 * b.abs()
            gaps.append(f"{name} max gap {float(gap.max()):.3e}, {int(outside.sum())} of "
                        f"{gap.numel()} outside rtol 1e-4 / atol 1e-5")
            check(float(outside.float().mean()) < 5e-4
                  and float(gap.max()) <= 2 * fed.local_steps * lr,
                  f"phase16b {case}: {name}: {gaps[-1]}")
        check(abs(lc - lh) <= 1e-5 * abs(lh), f"phase16b {case}: card loss {lc} != host {lh}")
        # what the sums decide: eq6's top-n upload choices against the sums
        # the round started from (the next round ranks against these sums),
        # for the clients that take part; a non-participant's upload has
        # weight 0, and its untrained row's scores are rounding noise
        part = torch.as_tensor(m) > 0
        s0 = host0["agg"]["prev_sums"][part]
        vc, vh = comp.contribution_scores(s0, sc[part]), comp.contribution_scores(s0, sh[part])
        uc, uh = comp.topn_mask(vc, fed.topn), comp.topn_mask(vh, fed.topn)
        check(bool((uc == uh).all()), f"phase16b {case}: eq6 uploads card {uc.tolist()} != host "
                                      f"{uh.tolist()} (scores {vc.tolist()} / {vh.tolist()})")
        top = torch.sort(vh, dim=-1, descending=True).values
        margin = float(((top[:, fed.topn - 1] - top[:, fed.topn]) / top[:, fed.topn - 1]).min())
        print(f"phase16b {case} ({cfg.name}, {cfg.n_layers} layers) one masked adamw eq6 round at "
              f"seq 128, K9/K10 {launches} on the card: card loss {lc!r} host loss {lh!r} (rel gap "
              f"{abs(lc - lh) / abs(lh):.3e}); {'; '.join(gaps)}; prev_sums max gap "
              f"{float((sc - sh).abs().max()):.3e} (max rel gap "
              f"{float(((sc - sh).abs() / sh.abs()).max()):.3e}); the participants' eq6 uploads equal on card and host "
              f"(host's top-{fed.topn} score margin {margin:.3e} of the score)"
              + (f"; 0 routing flips in the first step" if cfg.family == "moe" else "")
              + f"  [{card}]", flush=True)


def phase16c(dev, card: str) -> None:
    """Gradients through K9 windowed, K9 at llava's S 3968 with dead heads
    and K10 at zamba2's N 64 (``FAMILY_GRAD_ROWS``): kernel branch against
    plain branch on the card at phase 10b's bounds; llava's dead heads get
    an exactly zero ``wq`` gradient on both."""
    import dataclasses

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.models import attention as A
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T

    for arch, layers, positions, k9, k10 in FAMILY_GRAD_ROWS:
        cfg = family_cfg(arch, layers)
        kcfg = dataclasses.replace(cfg, attention_impl="kernel", ssm_impl="kernel")
        rcfg = dataclasses.replace(cfg, attention_impl="ref", ssm_impl="ref")
        weights = P.init_params(T.template(cfg), torch.Generator(device=dev).manual_seed(0))
        batch = _lm_batch(cfg, positions, dev)
        paths = [p for p, _ in P.flatten_with_paths(weights)]

        def run(c):
            p = P.map_tree(lambda w: w.clone().requires_grad_(True), weights)
            loss, _ = T.loss_fn(c, p, batch)
            leaves = [w for _, w in P.flatten_with_paths(p)]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), [torch.zeros_like(w) if g is None else g
                                   for w, g in zip(leaves, grads)]

        kflash.flash_attention.launches = kssd.ssd_chunk_scan.launches = 0
        lk, gk = run(kcfg)
        torch.cuda.synchronize()
        launches = (kflash.flash_attention.launches, kssd.ssd_chunk_scan.launches)
        check(launches == (k9, k10), f"phase16c {arch}: K9/K10 launches {launches} in one "
                                     f"checkpointed step (want {(k9, k10)})")
        lr_, gr = run(rcfg)
        check(bool(torch.isfinite(lk)) and abs(float(lk - lr_)) <= GRAD_LOSS_RTOL * abs(float(lr_)),
              f"phase16c {arch}: kernel loss {float(lk)} != plain {float(lr_)} at rtol "
              f"{GRAD_LOSS_RTOL}")
        worst, scale = 0.0, 0.0
        for path, a, b in zip(paths, gk, gr):
            check(torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL),
                  f"phase16c {arch}: grad {path} kernel != plain at rtol {GRAD_RTOL} / atol "
                  f"{GRAD_ATOL} (max gap {float((a - b).abs().max()):.3e})")
            worst = max(worst, float((a - b).abs().max()))
            scale = max(scale, float(b.abs().max()))
        note = ""
        if cfg.q_group_pad:
            dead = A.head_mask(cfg, dev) == 0
            wq = paths.index("layers/attn/wq")
            for g in (gk[wq], gr[wq]):
                check(not bool(g[:, :, dead].any()) and bool(g[:, :, ~dead].any()),
                      f"phase16c {arch}: a dead head's wq gradient is not 0")
            note = f"; the {int(dead.sum())} dead heads' wq gradient exactly 0 on both"
        shape = f"1 x {positions}" + (f" ({cfg.n_image_tokens} image tokens)"
                                      if cfg.modality == "vlm" else "")
        print(f"phase16c {arch} ({cfg.n_layers} layers, full width, f32) batch {shape}: loss "
              f"kernel {float(lk)!r} plain {float(lr_)!r} (rel gap "
              f"{abs(float(lk - lr_)) / abs(float(lr_)):.3e}, tol {GRAD_LOSS_RTOL}); grads max gap "
              f"{worst:.3e} (largest grad {scale:.3e}; rtol {GRAD_RTOL} / atol {GRAD_ATOL}); K9/K10 "
              f"launches {launches}{note}  [{card}]", flush=True)
        del weights, gk, gr
        torch.cuda.empty_cache()


def phase16d(dev, card: str) -> dict:
    """``examples/train_100m`` at its defaults for ``TRAIN_100M_ROUNDS``
    rounds: the reference's JSON keys, finite losses, K1 once a round and
    K9 twice a layer a local step. -> its launches."""
    import tempfile

    from repro_torch.examples import train_100m
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import pack

    pack.packed_bucket_reduce.launches = kflash.flash_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = train_100m.main(["--rounds", str(TRAIN_100M_ROUNDS), "--store", tmp,
                               "--device", str(dev)],
                              log=lambda msg: print(f"phase16d {msg}", flush=True))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k9 = pack.packed_bucket_reduce.launches, kflash.flash_attention.launches
    server = res.pop("server")
    steps = TRAIN_100M_ROUNDS * server.fed.n_clients
    check(set(res) >= {"params_M", "rounds", "loss_first", "loss_last", "wall_min", "cos_rounds"}
          and res["rounds"] == TRAIN_100M_ROUNDS and res["cos_rounds"] == [0]
          and all(np.isfinite(r.loss) for r in server.history), f"phase16d summary {res}")
    check(k1 == TRAIN_100M_ROUNDS and k9 == 2 * server.cfg.n_layers * steps,
          f"phase16d: K1 {k1}, K9 {k9} launches in {TRAIN_100M_ROUNDS} rounds of "
          f"{server.fed.n_clients} clients")
    losses = " ".join(repr(r.loss) for r in server.history)
    print(f"phase16d train_100m ({res['params_M']} M params, {server.fed.n_clients} clients, "
          f"{TRAIN_100M_ROUNDS} rounds) in {wall:.2f} s: loss {losses}; K1 {k1}, K9 {k9} "
          f"launches; peak_device_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}  [{card}]", flush=True)
    del server
    torch.cuda.empty_cache()
    return {"packed_bucket_reduce": k1, "flash_attention": k9}


def phase16(dev, card: str) -> dict:
    """Slice 7d on the card: 16a-16d. -> {kernel: {run: launches}}."""
    out = phase16a(dev, card)
    phase16b(dev, card)
    phase16c(dev, card)
    for k, v in phase16d(dev, card).items():
        out[k]["train_100m"] = v
    return out


# phase 17: the launch tooling. 17b dry-runs these plans on the meta device;
# 17c holds the 1 x 1 plan of phase 10d's qwen3-1.7b round against the card
PLAN_ROWS = [("qwen3-1.7b", "train_4k", False), ("grok-1-314b", "decode_32k", True),
             ("zamba2-2.7b", "long_500k", False)]
PLAN_STATE_ARCHS = ["grok-1-314b", "gemma3-27b"]
PLAN_STATE_MESHES = [{"data": 1, "model": 1}, {"data": 1, "model": 4}]
PLAN_FLOP_RTOL, PLAN_PEAK_RTOL = 1e-3, 0.10
PLAN_TIMED_ROUNDS = 2


def phase17a(card: str) -> None:
    """The launcher's ``--print-plan`` for every arch of the registry."""
    import contextlib
    import io

    from repro_torch.configs import REGISTRY
    from repro_torch.launch import train

    t0 = time.perf_counter()
    for arch in REGISTRY:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.print_plan(arch)
        lines = buf.getvalue().splitlines()
        check(len(lines) == 8 and lines[0] == f"== {arch}--train_4k--singlepod"
              and lines[4] == f"== {arch}--train_4k--multipod", f"phase17a {arch}: {lines}")
        for line in lines:
            print(f"phase17a {line}", flush=True)
    print(f"phase17a --print-plan for {len(REGISTRY)} archs in {time.perf_counter() - t0:.2f} s  "
          f"[{card}]", flush=True)


def phase17b(card: str) -> None:
    """``PLAN_ROWS`` through the dry-run on the meta device (per-device state
    and peak, FLOPs, bytes, collective bytes, the H100 roofline's terms),
    and the round state of the two largest train plans on small meshes."""
    from repro_torch.launch import dryrun, specs

    for arch, shape, multi in PLAN_ROWS:
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, shape, multi)
        secs = time.perf_counter() - t0
        mem, oc, rl = rec["memory"], rec["op_costs"], rec["roofline"]
        check(oc["flops_per_device"] > 0 and oc["traffic_bytes_per_device"] > 0
              and mem["total_per_device"] >= mem["state_per_device"] > 0,
              f"phase17b {rec['name']}: {mem} {oc['flops_per_device']}")
        print(f"phase17b {rec['name']} ({rec['mesh']}, {rec['kind']}, one replica of batch "
              f"{oc['replica_batch']} traced on meta in {rec['trace_s']} s): state "
              f"{mem['state_per_device'] / 2 ** 30:.3f} GiB and peak "
              f"{mem['total_per_device'] / 2 ** 30:.3f} GiB per device, "
              f"{oc['flops_per_device']:.4e} FLOP and {oc['traffic_bytes_per_device']:.4e} B per "
              f"device, collectives {json.dumps(oc['collective_bytes'])} B (cross-node "
              f"{json.dumps(oc['cross_node_bytes'])}); roofline on H100 constants: compute "
              f"{rl['compute_s']:.4e} s, memory {rl['memory_s']:.4e} s, collective "
              f"{rl['collective_s']:.4e} s, cross-node {rl['cross_node_s']:.4e} s, bound by "
              f"{rl['dominant']}; {secs:.2f} s  [{card}]", flush=True)
    for arch in PLAN_STATE_ARCHS:
        plan = specs.make_plan(arch, "train_4k", False)
        cells = []
        for sizes in PLAN_STATE_MESHES:
            for dt in (torch.float32, torch.bfloat16):
                got = dryrun.state_bytes(plan, sizes, dt)
                cells.append(f"({sizes['data']}, {sizes['model']}) {str(dt)[6:]} params "
                             f"{got / 1e9:.2f} GB ({'fits' if got <= dryrun.CARD_BYTES else 'over'})")
        need = dryrun.cards_for_state(arch)
        print(f"phase17b {arch} train_4k ({plan.kind}, adamw) round state per device against "
              f"{dryrun.CARD_BYTES / 1e9:.0f} GB: {'; '.join(cells)}; f32 state fits from "
              f"{need['cards']} cards ({need['mesh']}, {need['state_per_device'] / 1e9:.2f} GB "
              f"each)  [{card}]", flush=True)


def phase17c(dev, card: str) -> None:
    """The 1 x 1 plan of phase 10d's qwen3-1.7b round (full width and depth,
    C 2, 1 x 1024, eq6, adamw, f32) traced on meta, then one round on the
    card under the same counter: FLOPs within ``PLAN_FLOP_RTOL``, the
    predicted peak within ``PLAN_PEAK_RTOL`` of the measured, K9 and K1 as in
    10d; the measured round against the largest roofline term."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import packing
    from repro_torch.core import rounds as R
    from repro_torch.data.pipeline import fed_batches
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import pack
    from repro_torch.launch import op_analysis, roofline, specs, train
    from repro_torch.models.params import DEFAULT_RULES
    from repro_torch.optim import adamw

    arch = "qwen3-1.7b"
    args = train.build_parser().parse_args([
        "--task", "lm", "--arch", arch, "--full-size", "--clients", str(LM_TRAIN_CLIENTS),
        "--batch", str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ), "--device", str(dev)])
    cfg = dataclasses.replace(get_arch(arch), attention_impl="kernel", ssm_impl="kernel")
    fed = train.fed_config(args, cfg)  # the launcher's: eq6 on K1, as in 10d
    shape = ShapeConfig(f"train_{LM_TRAIN_SEQ}", LM_TRAIN_SEQ,
                        LM_TRAIN_CLIENTS * LM_TRAIN_BATCH, "train")
    plan = specs.LoweringPlan(cfg, shape, False, "train", fed, dict(DEFAULT_RULES), (),
                              fed.aggregation)
    one = {"data": 1, "model": 1}
    t0 = time.perf_counter()
    pred = op_analysis.trace_plan(plan, one, dtype=torch.float32)
    t_trace = time.perf_counter() - t0
    # a later round finds K1's (N,) bucket ids cached by the first: the same
    # trace with them live from the start
    spec = R.make_aggregator(cfg, fed).ctx.spec
    warm = op_analysis.count(specs.step_fn(plan), *specs.input_specs(plan, dtype=torch.float32)[0],
                             live=(packing.bucket_ids_on(spec, torch.device("meta")),))[1]
    rl = roofline.terms(dict(pred.flops), pred.traffic, {}, 1, cfg, shape,
                        other_ops=pred.other_ops)
    bound_s = max(rl.compute_s, rl.memory_s)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    opt = adamw(args.lr)
    state = R.make_state(cfg, fed, opt, R.seed_generator(cfg, 0, dev), device=dev)
    batch = R.to_device(next(fed_batches(cfg, fed, batch=args.batch, seq=args.seq, seed=1)), dev)
    weights = R.uniform_weights(fed.n_clients).to(dev)
    step = specs.step_fn(plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pack.packed_bucket_reduce.launches = kflash.flash_attention.launches = 0
    t1 = time.perf_counter()
    (state, metrics), got = op_analysis.count(step, state, batch, weights)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t1
    k1, k9 = pack.packed_bucket_reduce.launches, kflash.flash_attention.launches
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(PLAN_TIMED_ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, weights)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak_warm = torch.cuda.max_memory_allocated() - base
    want_k9 = 2 * cfg.n_layers * fed.n_clients * fed.local_steps
    check(np.isfinite(loss) and np.isfinite(float(metrics["loss"])), f"phase17c loss {loss}")
    check(k9 == want_k9 and k1 == 1 and got.kernels["flash_attention"]["launches"] == k9
          and pred.kernels["flash_attention"]["launches"] == k9
          and pred.kernels["packed_bucket_reduce"]["launches"] == 1,
          f"phase17c launches K9 {k9} K1 {k1} (want {want_k9}, 1); counted {got.kernels}, "
          f"traced {pred.kernels}")
    flop_err = abs(got.total_flops - pred.total_flops) / pred.total_flops
    peak_err = abs(pred.peak_bytes - peak) / peak
    warm_err = abs(warm.peak_bytes - peak_warm) / peak_warm
    check(warm.total_flops == pred.total_flops, f"phase17c: the warm trace counts "
                                                f"{warm.total_flops:.6e} FLOPs, the first "
                                                f"{pred.total_flops:.6e}")
    check(flop_err <= PLAN_FLOP_RTOL, f"phase17c FLOPs: card {got.total_flops:.6e}, meta "
                                      f"{pred.total_flops:.6e} ({flop_err:.2e} > {PLAN_FLOP_RTOL})")
    check(peak_err <= PLAN_PEAK_RTOL, f"phase17c peak: predicted {pred.peak_bytes / 2 ** 30:.3f} "
                                      f"GiB, measured {peak / 2 ** 30:.3f} GiB ({peak_err:.3f} > "
                                      f"{PLAN_PEAK_RTOL})")
    check(warm_err <= PLAN_PEAK_RTOL, f"phase17c later rounds' peak: predicted "
                                      f"{warm.peak_bytes / 2 ** 30:.3f} GiB, measured "
                                      f"{peak_warm / 2 ** 30:.3f} GiB ({warm_err:.3f} > "
                                      f"{PLAN_PEAK_RTOL})")
    round_ms = min(ms)
    print(f"phase17c {arch} 1 x 1 plan (full width and depth, C {fed.n_clients}, "
          f"{args.batch} x {args.seq}, eq6 top-{fed.topn} on K1, adamw, f32): traced on meta in "
          f"{t_trace:.2f} s ({pred.ops} ops), counted on the card in {counted_s:.2f} s; FLOPs "
          f"card {got.total_flops:.6e} meta {pred.total_flops:.6e} (rel {flop_err:.2e}, held "
          f"<= {PLAN_FLOP_RTOL}; by kind {json.dumps(dict(got.flops))}); peak predicted "
          f"{pred.peak_bytes / 2 ** 30:.3f} GiB measured {peak / 2 ** 30:.3f} GiB (rel "
          f"{peak_err:.3f}), the later rounds' with K1's ids cached predicted "
          f"{warm.peak_bytes / 2 ** 30:.3f} GiB measured {peak_warm / 2 ** 30:.3f} GiB (rel "
          f"{warm_err:.3f}; max_memory_allocated after reset_peak_memory_stats less "
          f"{base / 2 ** 30:.3f} GiB allocated before the state; held <= {PLAN_PEAK_RTOL}); "
          f"traffic card {got.traffic:.4e} meta {pred.traffic:.4e} B; "
          f"launches K9 {k9} K1 {k1}; loss {loss!r}  [{card}]", flush=True)
    print(f"phase17c roofline on H100 constants: compute {rl.compute_s * 1e3:.3f} ms, memory "
          f"{rl.memory_s * 1e3:.3f} ms; rounds {' '.join(f'{v:.3f}' for v in ms)} ms (after the "
          f"counted one): measured / max(term) = {round_ms / (bound_s * 1e3):.3f}  [{card}]",
          flush=True)
    del state, batch, metrics
    packing.bucket_ids_on.cache_clear()
    torch.cuda.empty_cache()


def phase17(dev, card: str) -> None:
    """Slice 8a on the card: the plans, the dry-run, the plan against a round."""
    phase17a(card)
    phase17b(card)
    phase17c(dev, card)


# phase 18: the sharded model. 18a fedyolov3 at full width, 2 rounds of
# sgd 0.05 a case; 18b qwen3-1.7b at its widths cut to 2 layers, one adamw
# eq6 round at 2 x 128; each on 2 ranks sharing the card over gloo
SHARD_IMG, SHARD_BATCH, SHARD_ROUNDS, SHARD_LR, SHARD_TOPN = 416, 2, 2, 0.05, 4
SHARD_MODES = ["dense", "eq6", "quant8"]
SHARD_ENGINE = dict(n_clients=4, mode="async", buffer_size=2, staleness_alpha=0.5)
SHARD_FLUSHES = 2
SHARD_LM = dict(layers=2, clients=2, batch=2, seq=128, lr=3e-3, topn=2)
# 18d: mamba2-1.3b at its widths cut to 12 layers, fedsgd sgd 0.05, one
# step at 2 x 128 (C 2 of 1 x 128, 1 x 128 a model rank), the layer gather
SHARD_SSM = dict(layers=12, clients=2, batch=1, seq=128)
SHARD_TIMEOUT_S = 300


def shard_fed(aggregation: str, **kw):
    from repro_torch.core.rounds import FedConfig

    base = dict(n_clients=2, local_steps=1, aggregation=aggregation, topn=SHARD_TOPN,
                client_axis="data", data_axis=None, agg_impl="kernel")
    return FedConfig(**{**base, **kw})


def within_10c(got: torch.Tensor, want: torch.Tensor, flips: bool = False) -> tuple[bool, str]:
    """Phase 10c's sgd bound, rtol 1e-4 / atol 1e-5 -> (held, what was
    seen). ``flips``: a rounding mode, where a gradient that differs by
    rounding moves a value across a half step: up to 1e-4 of the elements
    may be off, each by at most 1e-3 (the CPU tests' rule,
    tests/test_torch_sharded.py)."""
    gap = (got.float() - want.float()).abs()
    off = gap > 1e-5 + 1e-4 * want.float().abs()
    n_off, worst = int(off.sum()), float(gap.max())
    held = n_off <= (1e-4 * gap.numel() if flips else 0) and (not flips or worst <= 1e-3)
    return held, f"max gap {worst:.3e}, {n_off} of {gap.numel()} off rtol 1e-4 / atol 1e-5"


def synced_ms(fn) -> tuple[object, float]:
    """``fn()`` and its wall ms, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def say(msg: str, card: str) -> None:
    print(f"{msg}  [{card}]", flush=True)


def shard_rounds(cfg, fed, opt, batches, w, dev, mesh) -> dict:
    """``len(batches)`` rounds from the seed's state, on ``mesh`` or none ->
    the whole params, the last loss, ms per round, eq6's upload choices,
    the K1 and K5a launches and the host collectives' seconds."""
    from repro_torch.core import collectives, rounds
    from repro_torch.core import compression as comp
    from repro_torch.kernels import pack

    state = rounds.make_state(cfg, fed, opt, rounds.seed_generator(cfg, 0, dev), dev, mesh=mesh)
    fr = rounds.build_fed_round(cfg, fed, opt, mesh)
    pack.packed_bucket_reduce.launches = pack.quantize_rows.launches = 0
    collectives.reset_stats()
    ms, choices = [], []
    for b in batches:
        prev = state["agg"].get("prev_sums")
        (state, met), t = synced_ms(lambda: fr(state, b, w))
        ms.append(t)
        if prev is not None:
            choices.append(comp.topn_mask(comp.contribution_scores(prev, state["agg"]["prev_sums"]),
                                          fed.topn))
    params = state["params"]
    if mesh is not None and params.shape[-1] != rounds.make_aggregator(cfg, fed).ctx.spec.n_total:
        params = collectives.all_gather(params, mesh, "model", axis=-1)  # the rank's column block
    return {"params": params, "loss": float(met["loss"]), "ms": ms, "choices": choices,
            "k1": pack.packed_bucket_reduce.launches, "k5a": pack.quantize_rows.launches,
            "coll_s": collectives.stats["seconds"], "coll_calls": collectives.stats["calls"],
            "coll_bytes": collectives.stats["bytes"]}


def meshless_against(tag: str, got: dict, cfg, fed, opt, batches, w, dev, card: str,
                     flips: bool = False) -> None:
    """Rank 0's meshless runs of a sharded case from the same state: its
    twin (``microbatches`` 2, the parts the 2 ranks take) and the plain
    round (``microbatches`` 1), each held at phase 10c's bounds (``flips``:
    a rounding mode's), with equal eq6 upload choices. Neither is bitwise
    on the card: the clip's norm sums the blocks' parts, and a rank's
    convolutions run in another process."""
    for name, f in (("twin", dataclasses.replace(fed, microbatches=2)), ("meshless", fed)):
        want = shard_rounds(cfg, f, opt, batches, w, dev, None)
        held, seen = within_10c(got["params"], want["params"], flips)
        check(held and abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]),
              f"{tag}: sharded against the {name} run, {seen}, loss {got['loss']} {want['loss']}")
        check(all(torch.equal(a, b) for a, b in zip(got["choices"], want["choices"])),
              f"{tag}: upload choices differ from the {name} run's")
        say(f"phase{tag} against the {name} run: {seen}, loss {want['loss']!r}, ms per round "
            f"{[round(t, 1) for t in want['ms']]}"
            + (f", upload choices equal ({int(sum(c.sum() for c in got['choices']))} buckets "
               f"uploaded)" if got["choices"] else ""), card)
        del want


def phase18a(rank: int, dev, card: str) -> None:
    """fedyolov3 at full width, 2 rounds a case from the seed's state on both
    ranks: dense, eq6 and quant8 on a (1, 2) mesh (C 2), fedsgd (C 2) and the
    buffered engine (eq6, C 4, a flush every 2) on a (2, 1) mesh; rank 0
    runs each meshless and holds the gathered result at phase 10c's bounds,
    eq6's upload choices equal."""
    from repro_torch.configs import get_arch
    from repro_torch.core import async_engine as ae
    from repro_torch.core import rounds
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.kernels import pack
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import map_tree
    from repro_torch.optim import sgd

    cfg = get_arch("fedyolov3")
    m12, m21 = make_host_mesh(1, 2, "cuda"), make_host_mesh(2, 1, "cuda")
    opt = sgd(SHARD_LR)
    gen, _, _ = detection_suite(cfg, shard_fed("dense", n_clients=4), batch=SHARD_BATCH,
                                img_size=SHARD_IMG, pool_scenes=16)
    batches4 = [rounds.to_device(next(gen), dev) for _ in range(max(SHARD_ROUNDS, SHARD_FLUSHES))]
    batches = [map_tree(lambda x: x[:2], b) for b in batches4[:SHARD_ROUNDS]]
    w = rounds.uniform_weights(2).to(dev)
    for mode in SHARD_MODES:
        fed = shard_fed(mode)
        got = shard_rounds(cfg, fed, opt, batches, w, dev, m12)
        kernel = "K5a" if mode == "quant8" else "K1"
        launches = got["k5a"] if mode == "quant8" else got["k1"]
        check(launches == SHARD_ROUNDS, f"18a {mode}: {launches} {kernel} launches on rank {rank}")
        say(f"phase18a {mode} (1, 2) rank {rank}: {kernel} {launches} launches on the rank's "
            f"{'whole rows' if mode == 'quant8' else 'column block'}, ms per round "
            f"{[round(t, 1) for t in got['ms']]}, host collectives {got['coll_calls']} calls "
            f"{got['coll_s']:.3f} s, loss {got['loss']!r}", card)
        if rank == 0:
            meshless_against(f"18a {mode}", got, cfg, fed, opt, batches, w, dev, card,
                             flips=mode == "quant8")
        del got
    # fedsgd: the client axis as data-parallel ranks of one shared copy
    fed = shard_fed("fedsgd")
    merged = [rounds.merge_clients(b) for b in batches]
    got = shard_rounds(cfg, fed, opt, merged, w, dev, m21)
    say(f"phase18a fedsgd (2, 1) rank {rank}: ms per round {[round(t, 1) for t in got['ms']]}, "
        f"host collectives {got['coll_calls']} calls {got['coll_s']:.3f} s", card)
    if rank == 0:
        meshless_against("18a fedsgd", got, cfg, fed, opt, merged, w, dev, card)
    # the buffered engine: each rank trains the staged rows it owns
    fed = shard_fed("eq6", **SHARD_ENGINE)
    recs = {}
    for mesh in (m21, None) if rank == 0 else (m21,):
        eng = ae.BufferedAsyncEngine(cfg, fed, opt, seed=0, mesh=mesh, device=dev)
        pack.packed_bucket_reduce.launches = 0
        out, ms = [], []
        for b in batches4[:SHARD_FLUSHES]:
            rec, t = synced_ms(lambda: eng.step_round(b))
            out.append((rec.participants, rec.staleness, rec.dropped, rec.sim_time, rec.weights))
            ms.append(t)
        recs[mesh is None] = (out, eng.global_packed_row(), ms, pack.packed_bucket_reduce.launches)
    out, g, ms, k1 = recs[False]
    check(k1 == SHARD_FLUSHES, f"18a buffered: {k1} K1 launches on rank {rank}")
    say(f"phase18a buffered eq6 engine (2, 1) rank {rank}: K1 {k1} launches, ms per flush "
        f"{[round(t, 1) for t in ms]}, staged {[r[0] for r in out]}", card)
    if rank == 0:
        want, wg, wms, _ = recs[True]
        held, seen = within_10c(g, wg)
        check(out == want and held, f"18a buffered: records {out} != {want} or {seen}")
        say(f"phase18a buffered: records equal (staleness {[r[1] for r in out]}, sim seconds "
            f"{[round(r[3], 3) for r in out]}), global against meshless {seen}, ms per flush "
            f"meshless {[round(t, 1) for t in wms]}", card)


def phase18b(rank: int, dev, card: str) -> None:
    """qwen3-1.7b at its widths cut to 2 layers, one eq6 adamw round (C 2,
    one step at 2 x 128, 1 x 128 a model rank) on a (1, 2) mesh, attention
    through K9 as the launcher sets it: each rank's state bytes against the
    meshless state's and the dry-run's per-device bytes of the plan, the
    peak, the round's ms, the host collectives' seconds, the layer gather's
    counters and high-water, K9's launches (2 a layer a step); rank 0 holds
    the loss against the meshless run's."""
    from repro_torch.configs import get_arch
    from repro_torch.core import collectives, layer_gather, rounds
    from repro_torch.data.pipeline import fed_batches
    from repro_torch.kernels import pack
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw

    lm = SHARD_LM
    cfg = dataclasses.replace(get_arch("qwen3-1.7b"), n_layers=lm["layers"], attention_impl="kernel")
    fed = shard_fed("eq6", n_clients=lm["clients"], topn=lm["topn"])
    opt = adamw(lm["lr"])
    mesh = make_host_mesh(1, 2, "cuda")
    sizes = {"data": 1, "model": 2}
    batch = rounds.to_device(next(fed_batches(cfg, fed, batch=lm["batch"], seq=lm["seq"])), dev)
    w = rounds.uniform_weights(lm["clients"]).to(dev)
    meta = rounds.state_template(cfg, fed, opt, torch.float32)
    whole = rounds.state_bytes(meta)
    plan = specs.per_device_bytes(meta, rounds.state_pspecs(cfg, fed, opt, axis_sizes=sizes), sizes)
    n = rounds.make_aggregator(cfg, fed).ctx.spec.n_total
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = rounds.make_state(cfg, fed, opt, rounds.seed_generator(cfg, 0, dev), dev, mesh=mesh)
    mine = rounds.state_bytes(state)
    check(mine["clients"] * 2 == whole["clients"] and mine["server"] * 2 == whole["server"]
          and mine["other"] == whole["other"],
          f"18b rank {rank}: state bytes {mine} against the meshless {whole}")
    fr = rounds.build_fed_round(cfg, fed, opt, mesh)
    collectives.reset_stats()
    layer_gather.reset_stats()
    flash_attention.launches = pack.packed_bucket_reduce.launches = 0
    (state, met), ms = synced_ms(lambda: fr(state, batch, w))
    loss = float(met["loss"])
    peak = torch.cuda.max_memory_allocated()
    g = layer_gather.stats
    say(f"phase18b qwen3-1.7b (2 layers, N {n}) eq6 adamw (1, 2) rank {rank}: state "
        f"{mine['clients'] + mine['server']} B of the flat dim (meshless {whole['clients'] + whole['server']}"
        f" B, / 2 exactly) plus {mine['other']} B whole (per-bucket sums, step counts); the "
        f"dry-run's per-device bytes of the plan {plan} B; peak {peak / 2 ** 30:.3f} GiB; round "
        f"{ms:.1f} ms, host collectives {collectives.stats['calls']} calls "
        f"{collectives.stats['bytes'] / 1e9:.3f} GB {collectives.stats['seconds']:.3f} s (gloo "
        f"through pinned host memory, not NVLink); the gather {g['units']} units "
        f"{g['bytes'] / 1e9:.3f} GB, high-water {g['high'] / 1e6:.1f} MB (the row {n * 4 / 1e6:.1f} "
        f"MB); K9 {flash_attention.launches} K1 {pack.packed_bucket_reduce.launches} launches; "
        f"loss {loss!r}", card)
    check(0 < g["high"] < n * 4, f"18b rank {rank}: the gather's high-water {g['high']} B")
    check(flash_attention.launches == 2 * cfg.n_layers * lm["clients"],
          f"18b rank {rank}: {flash_attention.launches} K9 launches in {lm['clients']} local steps "
          f"of {cfg.n_layers} checkpointed layers")
    check(np.isfinite(loss), f"18b rank {rank}: loss {loss}")
    del state, met
    torch.cuda.empty_cache()
    if rank == 0:
        state = rounds.make_state(cfg, fed, opt, rounds.seed_generator(cfg, 0, dev), dev)
        check(rounds.state_bytes(state) == whole, "18b: the meshless state's bytes != its template's")
        (state, met), wms = synced_ms(lambda: rounds.build_fed_round(cfg, fed, opt)(state, batch, w))
        want = float(met["loss"])
        check(abs(loss - want) <= 1e-5 * abs(want), f"18b: loss {loss} against meshless {want}")
        say(f"phase18b meshless on rank 0: round {wms:.1f} ms, loss {want!r} (sharded within rtol "
            f"1e-5: {abs(loss - want) / abs(want):.3e})", card)
        del state, met
        torch.cuda.empty_cache()


def gather_arithmetic(arch: str) -> str:
    """The layer gather's sizes for ``arch`` at its published widths, from
    the pack spec alone (no tensor): N, the rest unit, the largest layer
    and a rank's f32 transient of 2 x (rest + one layer)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import layer_gather, packing, rounds

    cfg = get_arch(arch)
    tpl = rounds.make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    plan = layer_gather.build_plan(spec, tpl, 1)  # the units' sizes, whatever the mesh
    layer = max(u.size for u in plan.layers.values())
    return (f"phase18d the gather at {arch}'s widths (arithmetic): N {spec.n_total}, rest unit "
            f"{plan.rest.size} ({plan.rest.size * 4 / 1e9:.2f} GB f32), largest layer {layer} "
            f"({layer * 4 / 1e9:.2f} GB), 2 x (rest + layer) {2 * (plan.rest.size + layer) * 4 / 1e9:.2f}"
            f" GB a rank, the whole-row step's row and gradient {2 * spec.n_total * 4 / 1e9:.1f} GB")


def phase18d(rank: int, dev, card: str) -> None:
    """mamba2-1.3b at its widths cut to 12 layers, one fedsgd round (sgd
    0.05, C 2 merged into one step at 2 x 128, 1 x 128 a model rank) on a
    (1, 2) mesh, where the local step gathers the row layer by layer
    (``core.layer_gather``): each rank's state exactly half the meshless
    state, the gather's high-water within 2 x (rest + one layer), K10 2
    launches a layer (forward and recompute), the peak beside the
    whole-row step's arithmetic, the round's ms and the host collectives;
    rank 0 holds the loss and params against its meshless twin and the
    plain round (phase 10c's bounds)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import collectives, layer_gather, packing, rounds
    from repro_torch.data.pipeline import fed_batches
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import sgd

    lm = SHARD_SSM
    cfg = dataclasses.replace(get_arch("mamba2-1.3b"), n_layers=lm["layers"], ssm_impl="kernel")
    fed = shard_fed("fedsgd", n_clients=lm["clients"])
    opt = sgd(SHARD_LR)
    mesh = make_host_mesh(1, 2, "cuda")
    batch = rounds.merge_clients(rounds.to_device(
        next(fed_batches(cfg, fed, batch=lm["batch"], seq=lm["seq"])), dev))
    w = rounds.uniform_weights(lm["clients"]).to(dev)
    tpl = rounds.make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    n = spec.n_total
    plan = layer_gather.build_plan(spec, tpl, 2)
    layer = max(u.size for u in plan.layers.values())
    bound = 2 * (plan.rest.size + layer) * 4
    whole = rounds.state_bytes(rounds.state_template(cfg, fed, opt, torch.float32))
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()  # what earlier phases keep (K1's cached bucket ids)
    state = rounds.make_state(cfg, fed, opt, rounds.seed_generator(cfg, 0, dev), dev, mesh=mesh)
    mine = rounds.state_bytes(state)
    check(mine["server"] * 2 == whole["server"] and mine["clients"] == whole["clients"] == 0
          and mine["other"] == whole["other"],
          f"18d rank {rank}: state bytes {mine} against the meshless {whole}")
    peaks = {}

    def update(*args):  # the peak through the backward, then the optimizer's own
        peaks["backward"] = torch.cuda.max_memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        opt.update(*args)
        peaks["update"] = torch.cuda.max_memory_allocated() - before

    fr = rounds.build_fed_round(cfg, fed, dataclasses.replace(opt, update=update), mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the round's peak, the state in it
    collectives.reset_stats()
    layer_gather.reset_stats()
    ssd_chunk_scan.launches = 0
    (state, met), ms = synced_ms(lambda: fr(state, batch, w))
    peak = max(peaks.values())
    g, c, k10 = dict(layer_gather.stats), dict(collectives.stats), ssd_chunk_scan.launches
    got = {"params": collectives.all_gather(state["params"], mesh, "model"),
           "loss": float(met["loss"]), "choices": []}
    del state, met
    check(0 < g["high"] <= bound, f"18d rank {rank}: the gather's high-water {g['high']} B > {bound} B")
    check(k10 == 2 * cfg.n_layers, f"18d rank {rank}: {k10} K10 launches in one step of "
          f"{cfg.n_layers} checkpointed layers")
    check(np.isfinite(got["loss"]), f"18d rank {rank}: loss {got['loss']}")
    say(f"phase18d mamba2-1.3b ({cfg.n_layers} layers, N {n}: rest unit {plan.rest.size}, one "
        f"layer {layer}) fedsgd sgd (1, 2) rank {rank}: state {mine['server']} B (meshless "
        f"{whole['server']} B, / 2 exactly); the gather {g['units']} units {g['bytes']} B, "
        f"high-water {g['high']} B (bound 2 x (rest + one layer) {bound} B; the whole-row step's "
        f"row and gradient {2 * n * 4} B); peak {peak / 2 ** 30:.3f} GiB above the "
        f"{before / 2 ** 30:.3f} GiB earlier phases hold (backward {peaks['backward'] / 2 ** 30:.3f}, "
        f"update {peaks['update'] / 2 ** 30:.3f}; the whole-row step's state + row + gradient "
        f"{(mine['server'] + 2 * n * 4) / 2 ** 30:.3f} GiB before its temporaries); K10 {k10} launches; round {ms:.1f} ms, host collectives {c['calls']} "
        f"calls {c['bytes']} B {c['seconds']:.3f} s; loss {got['loss']!r}", card)
    if rank == 0:
        meshless_against("18d", got, cfg, fed, opt, [batch], w, dev, card)
        for arch in ("gemma3-27b", "grok-1-314b"):
            say(gather_arithmetic(arch), card)
    del got
    torch.cuda.empty_cache()


def phase18_rank(rank: int, tmp: str, card: str) -> None:
    """One of phase 18's two ranks on ``cuda:0``: a gloo group from a
    ``FileStore`` in ``tmp``, the kernels the parent built, 18a and 18b."""
    import datetime

    import torch.distributed as dist

    from repro_torch import device as D
    from repro_torch.kernels import _build

    dev = D.resolve("cuda")
    torch.cuda.set_device(0)  # both ranks on the one card
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2), rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    t0 = time.perf_counter()
    _build.library()  # built by the parent; a load under the build's file lock
    say(f"phase18 rank {rank}: {dist.get_backend_config()} group, kernels loaded in "
        f"{time.perf_counter() - t0:.2f} s", card)
    phase18a(rank, dev, card)
    phase18b(rank, dev, card)
    phase18d(rank, dev, card)
    dist.barrier()
    dist.destroy_process_group()


def phase18c(dev, card: str) -> None:
    """The launcher's 1 x 1 NCCL client mesh (``launch/train.py::client_mesh``)
    through the sharded code: one fedsgd round and one buffered flush of
    fedyolov3 at full width, bitwise against the meshless ones."""
    from repro_torch.configs import get_arch
    from repro_torch.core import async_engine as ae
    from repro_torch.core import collectives, rounds
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.launch import train
    from repro_torch.optim import sgd

    cfg = get_arch("fedyolov3")
    mesh = train.client_mesh(dev)
    opt = sgd(SHARD_LR)
    gen, _, _ = detection_suite(cfg, shard_fed("dense", n_clients=4), batch=SHARD_BATCH,
                                img_size=SHARD_IMG, pool_scenes=16)
    b4 = rounds.to_device(next(gen), dev)
    merged = rounds.merge_clients(b4)
    fed = shard_fed("fedsgd", n_clients=4)
    out = []
    for m in (mesh, None):
        got = shard_rounds(cfg, fed, opt, [merged], rounds.uniform_weights(4).to(dev), dev, m)
        out.append((got["params"], got["loss"]))
    check(same_bits(out[0][0], out[1][0]) and out[0][1] == out[1][1],
          "18c: fedsgd on the 1 x 1 NCCL mesh != meshless")
    fed = shard_fed("eq6", **SHARD_ENGINE)
    rows = []
    for m in (mesh, None):
        eng = ae.BufferedAsyncEngine(cfg, fed, opt, seed=0, mesh=m, device=dev)
        rec = eng.step_round(b4)
        rows.append((eng.state["params"].clone(), eng.global_packed_row(), rec.loss))
    check(same_bits(rows[0][0], rows[1][0]) and same_bits(rows[0][1], rows[1][1])
          and rows[0][2] == rows[1][2], "18c: a buffered flush on the 1 x 1 NCCL mesh != meshless")
    say(f"phase18c the launcher's 1 x 1 mesh ({collectives.backend(mesh.get_group('data'), dev)} "
        f"for {dev.type} tensors): one fedsgd round and one buffered eq6 flush of fedyolov3 at "
        f"{SHARD_IMG} bitwise equal to meshless", card)


def phase18(dev, card: str) -> None:
    """18a and 18b on two rank processes sharing the card; 18c here while
    they run (its checks are bitwise, not timed)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks need what earlier phases cached
    tmp = Path(tempfile.mkdtemp(prefix="phase18_"))
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase18-rank",
                               str(r), str(tmp), card], stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        phase18c(dev, card)
        for p in procs:
            p.wait(timeout=SHARD_TIMEOUT_S)
    finally:
        for p in procs:
            p.kill()
        out = []
        for log in logs:
            log.seek(0)
            out.append(log.read())
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    for r, (p, log) in enumerate(zip(procs, out)):
        print(log, end="", flush=True)
        check(p.returncode == 0, f"phase18 rank {r} exited {p.returncode}")
    say(f"phase18 {time.perf_counter() - t0:.1f} s", card)


# ---------------------------------------------------------------------------
# phase 19: the legacy tree layout
# ---------------------------------------------------------------------------

TREE_ROUNDS = 2
# (mode, FedConfig overrides, on the launcher's 1 x 1 mesh)
TREE_YOLO = [("dense", {}, False), ("eq6", dict(topn=4), False), ("static_topn", dict(topn=2), False),
             ("quant8", {}, True), ("quant8", {}, False)]
TREE_LM = dict(layers=2, clients=2, seq=128, lr=0.05, topn=2)
TREE_COUNTED = ("packed_bucket_reduce", "quant8_reduce", "quantize_rows")


def tree_twins(runs: dict, tag: str) -> None:
    """Fail unless the tree run equals its flat twin bit for bit: params,
    every moment, every aggregator state leaf, each round's loss."""
    from repro_torch.models.params import flatten_with_paths

    flat, tree = runs["flat"], runs["tree"]
    check(same_bits(tree["params"], flat["params"]), f"{tag}: tree params != flat params")
    check(tree["opt"].keys() == flat["opt"].keys(), f"{tag}: optimizer keys differ")
    for k, v in flat["opt"].items():
        check(same_bits(tree["opt"][k], v), f"{tag}: tree {k} != flat {k}")
    leaves = [dict(flatten_with_paths(r["agg"])) for r in (flat, tree)]
    check(leaves[0].keys() == leaves[1].keys(), f"{tag}: aggregator state keys differ")
    for path, v in leaves[0].items():
        x, y = torch.as_tensor(leaves[1][path]), torch.as_tensor(v)
        check(same_bits(x, y) if y.dtype == torch.float32 else torch.equal(x, y),
              f"{tag}: aggregator state {path} differs")
    check(tree["losses"] == flat["losses"], f"{tag}: losses {tree['losses']} != {flat['losses']}")


def phase19a(dev, card: str) -> dict:
    """fedyolov3 at full width through ``FLServer``, tree against flat. ->
    the tree rounds' launches of K1, K4 and K5a."""
    from repro_torch.configs import get_arch
    from repro_torch.core import rounds
    from repro_torch.core.rounds import FedConfig
    from repro_torch.core.server import FLServer
    from repro_torch.data.pipeline import detection_suite
    from repro_torch.kernels import pack
    from repro_torch.launch import train
    from repro_torch.optim import sgd

    cfg = get_arch("fedyolov3")
    counters = {k: getattr(pack, k) for k in TREE_COUNTED}
    total = dict.fromkeys(TREE_COUNTED, 0)
    batches = None
    for mode, kw, on_mesh in TREE_YOLO:
        runs = {}
        for layout in ("flat", "tree"):
            fed = FedConfig(n_clients=3, aggregation=mode, agg_impl="kernel", client_axis="data",
                            data_axis=None, state_layout=layout, **kw)
            if batches is None:
                gen, _, _ = detection_suite(cfg, fed, batch=2, img_size=IMG, pool_scenes=24)
                batches = [next(gen) for _ in range(TREE_ROUNDS)]
            srv = FLServer(cfg, fed, sgd(0.05), seed=0, device=dev,
                           mesh=train.client_mesh(dev) if on_mesh else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            ms, losses = [], []
            for b in batches:
                t0 = time.perf_counter()
                losses.append(srv.run_round(b).loss)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            state = rounds.flat_state(srv.aggregator, srv.state) if layout == "tree" else srv.state
            runs[layout] = {**state, "losses": losses, "ms": ms,
                            "launches": {k: fn.launches for k, fn in counters.items()},
                            "peak": torch.cuda.max_memory_allocated() / 2**30}
            del srv, state
        tag = f"phase19a {mode}" + (" on the 1 x 1 mesh" if on_mesh else "")
        tree_twins(runs, tag)
        n = runs["tree"]["launches"]
        want = {"packed_bucket_reduce": 0, "quant8_reduce": 0, "quantize_rows": 0}
        want["quantize_rows" if on_mesh else "quant8_reduce" if mode == "quant8"
             else "packed_bucket_reduce"] = TREE_ROUNDS
        check(n == want and runs["flat"]["launches"] == want,
              f"{tag}: launches tree {n}, flat {runs['flat']['launches']}, want {want}")
        for k in TREE_COUNTED:
            total[k] += n[k]
        print(f"{tag}: tree == flat bitwise over {TREE_ROUNDS} rounds (params, moments, agg "
              f"state, losses {' '.join(repr(x) for x in runs['tree']['losses'])}); ms per round "
              f"tree {' '.join(f'{t:.3f}' for t in runs['tree']['ms'])} flat "
              f"{' '.join(f'{t:.3f}' for t in runs['flat']['ms'])}; peak tree "
              f"{runs['tree']['peak']:.3f} GiB flat {runs['flat']['peak']:.3f} GiB; launches {n}"
              f"  [{card}]", flush=True)
        del runs
        torch.cuda.empty_cache()
    return total


def phase19b(dev, card: str) -> int:
    """qwen3-1.7b, 2 layers at full width: tree rounds against flat, then
    ``core.fedavg`` on the card against the packed aggregators. -> the tree
    rounds' K1 launches."""
    from repro_torch.core import compression as comp
    from repro_torch.core import fedavg, packing, rounds
    from repro_torch.core.rounds import FedConfig
    from repro_torch.kernels import pack
    from repro_torch.optim import sgd

    cfg, C = family_cfg("qwen3-1.7b", TREE_LM["layers"]), TREE_LM["clients"]
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (C, 1, 1, TREE_LM["seq"])))
                .to(dev)} for _ in range(TREE_ROUNDS)]
    w = rounds.uniform_weights(C).to(dev)
    total = 0
    for mode in ("eq6", "static_topn"):
        runs = {}
        for layout in ("flat", "tree"):
            fed = FedConfig(n_clients=C, aggregation=mode, topn=TREE_LM["topn"], agg_impl="kernel",
                            state_layout=layout)
            opt = sgd(TREE_LM["lr"])
            agg = rounds.make_aggregator(cfg, fed)
            state = rounds.make_state(cfg, fed, opt, rounds.seed_generator(cfg, 0, dev), dev)
            fr = rounds.build_fed_round(cfg, fed, opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pack.packed_bucket_reduce.launches = 0
            ms, losses = [], []
            for b in batches:
                t0 = time.perf_counter()
                state, m = fr(state, b, w)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            flat = rounds.flat_state(agg, state) if layout == "tree" else state
            runs[layout] = {**flat, "losses": losses, "ms": ms,
                            "launches": pack.packed_bucket_reduce.launches,
                            "peak": torch.cuda.max_memory_allocated() / 2**30}
            del state, flat
        N = agg.ctx.spec.n_total
        check(N == 411_838_976, f"phase19b N {N}")
        tree_twins(runs, f"phase19b {mode}")
        n = runs["tree"]["launches"]
        check(n == runs["flat"]["launches"] == TREE_ROUNDS,
              f"phase19b {mode}: K1 launched {n} (tree), {runs['flat']['launches']} (flat)")
        total += n
        print(f"phase19b qwen3-1.7b 2 layers (N {N}) {mode} C {C} 1 x {TREE_LM['seq']}: tree == "
              f"flat bitwise over {TREE_ROUNDS} rounds (losses "
              f"{' '.join(repr(x) for x in runs['tree']['losses'])}); ms per round tree "
              f"{' '.join(f'{t:.3f}' for t in runs['tree']['ms'])} flat "
              f"{' '.join(f'{t:.3f}' for t in runs['flat']['ms'])}; peak tree "
              f"{runs['tree']['peak']:.3f} GiB flat {runs['flat']['peak']:.3f} GiB; K1 {n}"
              f"  [{card}]", flush=True)
        del runs
        torch.cuda.empty_cache()

    # core.fedavg on the card against the packed aggregators, one input
    eq6 = rounds.make_aggregator(cfg, FedConfig(n_clients=C, aggregation="eq6", topn=TREE_LM["topn"],
                                                agg_impl="kernel"))
    spec, tpl = eq6.ctx.spec, eq6.ctx.template
    base_rows = rounds.initial_row(eq6, rounds.seed_generator(cfg, 0, dev), dev).expand(C, -1)
    g = torch.Generator(device=dev).manual_seed(1)
    rows = base_rows + 0.01 * torch.randn(base_rows.shape, generator=g, device=dev)
    base, stacked = packing.unpack(spec, base_rows, tpl), packing.unpack(spec, rows, tpl)
    w = torch.tensor([0.6, 0.4], device=dev)
    t0 = time.perf_counter()
    prev = comp.layer_sums(cfg, tpl, base)
    legacy, sums = fedavg.aggregate_eq6(cfg, tpl, stacked, w, prev, TREE_LM["topn"])
    legacy = packing.pack(spec, legacy)
    torch.cuda.synchronize()
    eq6_ms = (time.perf_counter() - t0) * 1e3
    st0 = eq6.init_state(base_rows)
    out, st1 = eq6.aggregate(rows.clone(), w, st0)
    gap = float((legacy - out).abs().max())
    choice = lambda p, s: comp.topn_mask(comp.contribution_scores(p, s), TREE_LM["topn"])
    check(gap < 1e-5, f"phase19b fedavg eq6 vs packed eq6: max abs gap {gap:.3e}")
    check(torch.equal(choice(prev, sums), choice(st0["prev_sums"], st1["prev_sums"])),
          "phase19b fedavg eq6's upload choices != the packed eq6's")
    check(torch.allclose(sums, st1["prev_sums"], rtol=1e-5, atol=1e-3),
          "phase19b fedavg eq6's sums != the packed eq6's")
    del legacy, out
    q8 = rounds.make_aggregator(cfg, FedConfig(n_clients=C, aggregation="quant8", agg_impl="kernel"))
    w = rounds.uniform_weights(C).to(dev)
    t0 = time.perf_counter()
    legacy = packing.pack(spec, fedavg.aggregate_quant8(stacked, base, w))
    torch.cuda.synchronize()
    q8_ms = (time.perf_counter() - t0) * 1e3
    out, _ = q8.aggregate(rows.clone(), w, {"base": base_rows[0].clone()})
    step = float((rows - base_rows).abs().max()) / 127.0
    qgap = float((legacy - out).abs().max())
    check(qgap < 2 * step + 1e-7, f"phase19b fedavg quant8 vs packed quant8: gap {qgap:.3e} "
                                  f"(step {step:.3e})")
    print(f"phase19b core.fedavg on the card, (C {C}, N {spec.n_total}): aggregate_eq6 {eq6_ms:.1f} "
          f"ms, max abs gap {gap:.3e} to the packed eq6 (K1), the same upload choices; "
          f"aggregate_quant8 {q8_ms:.1f} ms, gap {qgap:.3e} to the packed quant8 (K4), one step "
          f"{step:.3e}  [{card}]", flush=True)
    del base, stacked, legacy, out, rows, base_rows
    torch.cuda.empty_cache()
    return total


def phase19(dev, card: str) -> dict:
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches = phase19a(dev, card)
    launches["packed_bucket_reduce"] += phase19b(dev, card)
    print(f"phase19 {time.perf_counter() - t0:.1f} s; tree rounds' launches {launches}  [{card}]",
          flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    t_start = time.perf_counter()

    def mark(phase: str) -> None:  # the script runs against a 1200 s limit
        print(f"{phase} starts at {time.perf_counter() - t_start:.1f} s", flush=True)

    from repro_torch import device as D
    from repro_torch.configs import get_arch
    from repro_torch.core import detection, serving
    from repro_torch.kernels import _build, detect
    from repro_torch.models.yolov3 import FedYOLOv3

    # ---- phase 1: device and build -------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = D.resolve("cuda")
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 still on")
    t0 = time.perf_counter()
    _build.library()
    print(f"phase1 build {', '.join(_build.SOURCES)} (sm_90a, -fmad=false): "
          f"{time.perf_counter() - t0:.3f} s; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: kernel vs plain on the card ---------------------------
    mark("phase 2")
    n_cases = phase2(dev, card)

    # ---- phase 3: the detection service at full width -------------------
    mark("phase 3")
    cfg, fed, model, imgs = served_model(dev)
    n_params = sum(p.numel() for p in model.parameters())
    slot = serving.ModelSlot()
    slot.publish(1, model)
    n_req = REQUESTS_PER_CLIENT * CLIENTS
    svc = serving.InferenceService(cfg, fed, slot, img_size=IMG, device=dev).start()
    results: dict[int, serving.ServeResult] = {}
    latencies: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def client_loop(c: int) -> None:
        try:
            with serving.InferenceClient(svc.host, svc.port, timeout=120.0) as cl:
                for r in range(REQUESTS_PER_CLIENT):
                    i = c * REQUESTS_PER_CLIENT + r
                    t1 = time.perf_counter()
                    res = cl.infer(imgs[i % SCENES])
                    dt = time.perf_counter() - t1
                    with lock:
                        results[i] = res
                        latencies.append(dt)
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    try:
        with serving.InferenceClient(svc.host, svc.port, timeout=300.0) as warm:
            warm.infer(imgs[0])  # first cuDNN and kernel use stay out of the timings
        batches0 = svc.stats.batches
        detect.nms_keep.launches = 0
        threads = [threading.Thread(target=client_loop, args=(c,)) for c in range(CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = detect.nms_keep.launches
        batches = svc.stats.batches - batches0
        check(not any(t.is_alive() for t in threads), "a client did not finish")
        check(not errors, f"client error: {errors[:1]!r}")
        with serving.InferenceClient(svc.host, svc.port, timeout=120.0) as cl:
            lone = cl.infer(imgs[SCENES])  # rides alone: slot 0 of a zero-padded batch
            status = cl.status()
    finally:
        svc.stop()
    check(len(results) == n_req, f"{len(results)} of {n_req} requests answered")
    check(status["in_flight"] == 0, f"{status['in_flight']} requests dropped")
    check(all(r.version == 1 for r in results.values()) and lone.version == 1,
          "a RESULT carries a version other than 1")
    n_dets = sum(len(r.detections) for r in results.values())
    check(n_dets > 0, "no detection served")
    check(launches >= 1, "the NMS kernel did not launch on the served path")
    check(launches == batches, f"{launches} NMS launches for {batches} served batches")

    program = serving.detection_program(cfg, fed.serve_max_detections, dev)
    padded = np.zeros((fed.serve_batch, IMG, IMG, 3), np.float32)
    padded[0] = imgs[SCENES]
    direct = serving.to_host(program(model, torch.from_numpy(padded)))

    def f32(dets):
        return [(l, np.float32(s), tuple(np.float32(b))) for l, s, b in dets]

    check(f32(serving.decode_result(direct, 0)) == f32(lone.detections),
          "padded-batch pin: lone RESULT != direct program output")
    full_imgs = imgs[SCENES: SCENES + 8]
    full = serving.to_host(program(model, torch.from_numpy(np.ascontiguousarray(full_imgs))))
    for key in ("boxes", "scores", "cls", "valid"):
        check(np.array_equal(full[key][0].view(np.int32), direct[key][0].view(np.int32)),
              f"padded-batch pin: slot 0 {key} differs between full and lone batch")
    batch = torch.from_numpy(np.ascontiguousarray(full_imgs)).to(dev)
    with torch.inference_mode():
        by_kernel = detection.decode_predictions(cfg, model, batch, max_detections=16)
        by_plain = detection.decode_predictions(cfg, model, batch, max_detections=16, impl="ref")
        torch.cuda.synchronize()
        for key in ("boxes", "scores", "cls", "valid"):
            check(same_bits(by_kernel[key], by_plain[key]),
                  f"decode with the CUDA NMS != decode with the plain NMS: {key}")
        check(all(torch.isfinite(by_kernel[k]).all() for k in ("boxes", "scores")),
              "non-finite detections")
        check(by_kernel["boxes"].shape == (8, 16, 4), "wrong detection shape")

        # the card's f32 agrees with the host path the CPU tests hold against
        # the reference: raw heads at full width, rtol 1e-4 / atol 1e-5 (the
        # tolerance of tests/test_torch_yolo.py; TF32 would miss it by ~10x)
        host_model = FedYOLOv3(cfg)
        host_model.load_state_dict(model.state_dict())
        on_card = [o.cpu() for o in model(batch[:1])]
        on_host = host_model.eval()(batch[:1].cpu())
        for a, b in zip(on_card, on_host):
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
                  f"card forward != host forward: max err {float((a - b).abs().max()):.3e}")

        # where a served batch's device time goes
        batch_ms = time_ms(lambda: program(model, batch), reps=20)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                program(model, batch)
            torch.cuda.synchronize()
        rows = sorted(((e.device_time_total / 5e3, e.count // 5, e.key) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.device_time_total > 0), reverse=True)
        prof_note = "not measured (the profiler recorded no device kernel)"
        if rows:
            dev_ms = sum(r[0] for r in rows)
            prof_note = (f"device kernel time {dev_ms:.4f} ms per batch of {batch_ms:.4f} ms "
                         f"(idle share {1 - dev_ms / batch_ms:.3f})")
            for ms, cnt, key in rows[:10]:
                print(f"phase3 profile {ms:9.4f} ms/batch x{cnt:3d}  {key[:100]}", flush=True)
            nms_rows = [r for r in rows if "nms_" in r[2]]
            check(len(nms_rows) == 1 and nms_rows[0][1] == 1 and "nms_bitmask_kernel" in nms_rows[0][2],
                  "the profile shows no single nms_bitmask_kernel launch per batch")
            print(f"phase3 profile nms_bitmask_kernel device time {nms_rows[0][0] * 1e3:.2f} us "
                  f"per batch", flush=True)
        print(f"phase3 profile: {prof_note}  [{card}]", flush=True)

    # the kernel at the served shape, on the served inputs
    nms_stats = served_nms(*served_nms_operands(model, batch, fed), card)

    lat = sorted(latencies)
    p50 = lat[len(lat) // 2] * 1e3
    p90 = lat[min(len(lat) - 1, int(len(lat) * 0.90))] * 1e3
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    print(f"phase3 fedyolov3 full width ({n_params} params) img {IMG} serve_batch {fed.serve_batch}: "
          f"{n_req} requests from {CLIENTS} closed-loop clients, 0 dropped, {n_dets} detections, "
          f"{batches} batches (avg occupancy {n_req / batches:.2f}), version 1 everywhere, "
          f"padded-batch pin holds, CUDA NMS == plain NMS  [{card}]", flush=True)
    print(f"phase3 qps={n_req / wall:.2f} p50_ms={p50:.3f} p90_ms={p90:.3f} p99_ms={p99:.3f} "
          f"(p99 of {len(lat)} samples) program_ms_per_batch={batch_ms:.3f} "
          f"nms_kernel_ms_per_batch={nms_stats['ms']:.5f} nms_device_ms={nms_stats['device_ms']} "
          f"nms_plain_ms={nms_stats['plain_ms']:.5f}  [{card}]", flush=True)

    # ---- phases 4 and 5: the training path's kernels and the path -------
    mark("phase 4")
    k_stats = phase4(dev, card)
    floor_ms, floor_from = nms_stats["launch_floor_ms"], nms_stats["launch_floor_ms_from"]
    print(f"phase4 launch floor (a one-element kernel, phase 3): device_ms={floor_ms} "
          f"({floor_from}); the launch-bound K3 (nms_keep) and K2 (pairwise_iou) are bound by the "
          f"larger of it and their bytes  [{card}]", flush=True)
    train_launches = phase5(dev, card)

    # ---- phases 6 and 7: the uplink's kernels and its modes --------------
    mark("phase 6")
    k_stats.update(phase6(dev, card))
    uplink_launches, uplink_buffer = phase7(dev, card)

    # ---- phases 8 and 9: the LM kernels and the LM serve path ------------
    mark("phase 8")
    k_stats.update(phase8(dev, card))
    lm_launches = phase9(dev, card)

    # ---- phase 10: K11, gradients through K9/K10, LM training, the demo ---
    mark("phase 10")
    from repro_torch.core import packing
    from repro_torch.models import transformer as T
    qcfg = get_arch("qwen3-1.7b")
    largest = max(sl.size for sl in packing.build_pack_spec(qcfg, T.template(qcfg)).slots)
    k_stats["fedavg_masked_mean"] = phase10a(dev, card, largest)
    phase10b(dev, card)
    phase10c(dev, card)
    lm_train = phase10de(dev, card)

    # ---- phase 11: the row and block quantizers, compact, fedsgd ---------
    mark("phase 11")
    k_stats.update(phase11a(dev, card))
    phase11b(dev, card, uplink_buffer)
    del uplink_buffer
    compact_launches = phase11c(dev, card)
    phase11d(dev, card)

    # ---- phase 12: the async control plane --------------------------------
    mark("phase 12")
    async_launches = phase12a(dev, card)
    phase12b(dev, card)
    async_launches.update({f"arrival_{k}": v for k, v in phase12c(dev, card).items()})

    # ---- phase 13: the wire at full width ----------------------------------
    mark("phase 13")
    wire13 = phase13a(dev, card)
    wire_launches = {f"socket_{k}": v["launches"] for k, v in wire13["runs"].items()}
    wire_launches["kill_restore"] = phase13b(dev, card)
    phase13c(dev, card)

    # ---- phase 14: the multi-task platform ---------------------------------
    mark("phase 14")
    platform = phase14(dev, card)

    # ---- phase 15: the other LM families served -----------------------------
    mark("phase 15")
    families = phase15(dev, card)

    # ---- phase 16: the other LM families trained ----------------------------
    mark("phase 16")
    families_train = phase16(dev, card)
    trained = (f"phase 16: {FAMILY_TRAIN_ROUNDS} launcher rounds per arch at C "
               f"{FAMILY_TRAIN_CLIENTS}, train_100m's {TRAIN_100M_ROUNDS}")

    # ---- phase 17: the launch tooling ---------------------------------------
    mark("phase 17")
    t17 = time.perf_counter()
    phase17(dev, card)
    print(f"phase17 {time.perf_counter() - t17:.1f} s  [{card}]", flush=True)

    # ---- phase 18: the sharded model ----------------------------------------
    mark("phase 18")
    phase18(dev, card)

    # ---- phase 19: the legacy tree layout -----------------------------------
    mark("phase 19")
    tree = phase19(dev, card)
    tree_path = (f"phase 19: {TREE_ROUNDS} tree rounds per mode, fedyolov3 full width (dense, "
                 f"eq6, static_topn, quant8 on the 1 x 1 mesh and without one) and qwen3-1.7b at "
                 f"2 layers (eq6, static_topn)")

    def entry(name, source, replaces, launches, st, **extra):
        keys = ("max_abs_err", "ms", "device_ms", "device_ms_from", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "cases")
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
                **{k: st.get(k) for k in keys}, **extra}

    def tc_keys(name):  # K9/K10: the FP32 units' bound, the SASS's tensor-core count
        return {k: k_stats[name][k] for k in ("bound_ms_fp32_units", "sass_hmma")}

    k_stats["nms_keep"] = dict(nms_stats, cases=n_cases)
    uplink = {path: f"--agg {path}, {uplink_launches[f'{path}_rounds']} rounds"
              for path in ("hier", "quant4", "secure")}
    lm = {k: dict(launches_training=lm_train[k]["launches"], training_path=lm_train[k]["main_path"],
                  main_path=lm_launches[k]["main_path"], launches_families={
                      **families[k], "main_path": f"phase 15: serve --full-size, one prefill and "
                                                  f"{FAMILY_NEW} new tokens per arch"},
                  launches_families_training={**families_train[k], "main_path": trained})
          for k in ("flash_attention", "ssd_chunk_scan")}
    demo = lm_train["fedavg_masked_mean"]
    kernels = [
        entry("nms_keep", "nms.cu", "detect.py:173", launches, k_stats["nms_keep"],
              launches_training=train_launches["nms_keep"], launch_floor_ms=floor_ms,
              launch_floor_ms_from=floor_from,
              launches_platform={"serving_view": platform["k3"], "main_path": f"phase 14c: "
                                 f"{PLATFORM_REQUESTS} requests to the platform's trained detector"}),
        entry("packed_bucket_reduce", "bucket_reduce.cu", "pack.py:132",
              train_launches["packed_bucket_reduce"], k_stats["packed_bucket_reduce"],
              launches_lm_training=lm_train["packed_bucket_reduce"],
              launches_families_training={**families_train["packed_bucket_reduce"],
                                          "main_path": trained},
              launches_demo=lm_train["packed_bucket_reduce_demo"],
              launches_async={**async_launches, "main_path": f"phase 12: {ASYNC_FLUSHES} "
                              f"buffered flushes, {ASYNC_LAUNCHER_FLUSHES} through the launcher, "
                              f"5 landing flushes per codec"},
              launches_wire={**wire_launches, "main_path": f"phase 13: the WireServer's "
                             f"landing flushes at qwen3-1.7b full width, 2 layers (N = "
                             f"{wire13['n']}), {WIRE_FLUSHES} under quant8, {WIRE_FLUSHES} "
                             f"dense across a kill and restore (plus the flushes its recovery "
                             f"replays)"},
              wire_max_abs_err=wire13["max_abs_err"], wire_device_ms=wire13["device_ms"],
              wire_device_ms_from=wire13["device_ms_from"], wire_bound_ms=wire13["bound_ms"],
              launches_platform={**platform["k1"], "main_path": f"phase 14: the platform's "
                                 f"{PLATFORM_LM_ROUNDS} eq6 and {PLATFORM_YOLO_ROUNDS} dense rounds, "
                                 f"the shared clock's {CLOCK_SYNC_ROUNDS} rounds and "
                                 f"{CLOCK_FLUSHES} flushes, the quickstart's "
                                 f"{PLATFORM_QUICKSTART_ROUNDS} rounds"},
              platform_shapes=platform["k1_shapes"],
              launches_tree={"rounds": tree["packed_bucket_reduce"], "main_path": tree_path}),
        entry("pairwise_iou", "iou.cu", "detect.py:111", train_launches["pairwise_iou"],
              k_stats["pairwise_iou"], launch_floor_ms=floor_ms, launch_floor_ms_from=floor_from),
        entry("quant8_reduce", "quant_reduce.cu", "pack.py:285", uplink_launches["quant8_reduce"],
              k_stats["quant8_reduce"], main_path=f"FLServer quant8 without a client mesh, "
              f"{uplink_launches['quant8_meshless_rounds']} rounds",
              flushed_l2_device_ms=k_stats["quant8_reduce"]["flushed_l2_device_ms"],
              launches_tree={"rounds": tree["quant8_reduce"], "main_path": tree_path}),
        entry("grouped_reduce", "grouped_reduce.cu", "pack.py:342", uplink_launches["grouped_reduce"],
              k_stats["grouped_reduce"], main_path=uplink["hier"]),
        entry("quant4_reduce", "quant_reduce.cu", "quant4.py:101", uplink_launches["quant4_reduce"],
              k_stats["quant4_reduce"], main_path=uplink["quant4"],
              **{k: k_stats["quant4_reduce"][k]
                 for k in ("flushed_l2_device_ms", "nearest_ms", "nearest_device_ms")}),
        entry("masked_u32_sum", "masked_sum.cu", "mask.py:57", uplink_launches["masked_u32_sum"],
              k_stats["masked_u32_sum"], main_path=uplink["secure"]),
        entry("flash_attention", "flash_attention.cu", "flash_attention.py:98",
              lm_launches["flash_attention"]["launches"], k_stats["flash_attention"],
              **lm["flash_attention"], **tc_keys("flash_attention")),
        entry("ssd_chunk_scan", "ssd_scan.cu", "ssd_scan.py:51", lm_launches["ssd_chunk_scan"]["launches"],
              k_stats["ssd_chunk_scan"], **lm["ssd_chunk_scan"], **tc_keys("ssd_chunk_scan")),
        entry("fedavg_masked_mean", "fedavg.cu", "fedavg.py:36", demo["launches"],
              k_stats["fedavg_masked_mean"], main_path=demo["main_path"], tree_ms=demo["tree_ms"],
              tree_device_ms=demo["tree_device_ms"], tree_device_ms_from=demo["tree_device_ms_from"]),
        entry("quantize_rows", "row_quant.cu", "pack.py:200", uplink_launches["quantize_rows"],
              k_stats["quantize_rows"], launches_compact=compact_launches["quant8"]["quantize_rows"],
              flushed_l2_device_ms=k_stats["quantize_rows"]["flushed_l2_device_ms"],
              main_path=f"--agg quant8 on the launcher's 1 x 1 mesh, "
              f"{uplink_launches['quant8_rounds']} rounds",
              launches_tree={"rounds": tree["quantize_rows"], "main_path": tree_path}),
        entry("dequantize_rows", "row_quant.cu", "pack.py:231", uplink_launches["dequantize_rows"],
              k_stats["dequantize_rows"], launches_compact=compact_launches["quant8"]["dequantize_rows"],
              main_path="none: no round decodes the payload row-wise (the reference's tests only); "
              "counted over phase 7b's launcher runs and its meshless quant8 run"),
        entry("quantize", "row_quant.cu", "quant.py:38", k_stats["quantize"]["launches"],
              k_stats["quantize"], main_path="ops.quantize_tree over fedyolov3's tree, one launch "
              "per leaf (no runtime caller)"),
        entry("dequantize", "row_quant.cu", "quant.py:61", k_stats["dequantize"]["launches"],
              k_stats["dequantize"], main_path="ops.dequantize_tree over fedyolov3's tree, one "
              "launch per tree (no runtime caller)"),
    ]
    import torch.distributed as dist

    if dist.is_initialized():  # the launcher's one-rank client group
        dist.destroy_process_group()
    mark("the summary")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase18-rank"]:  # one of phase 18's rank processes
        phase18_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()

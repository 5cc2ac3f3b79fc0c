#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and hold its
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each a hard check (any failure exits non-zero, with no result line):

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of the CUDA kernel from ``src/repro_torch/kernels/csrc`` and its time.
2. Kernel vs plain: the CUDA NMS scan against the plain PyTorch scan, both
   on the card, over six case kinds at (B, N) in (1, 1), (8, 16), (64, 100),
   (4, 1024). Keep masks must be bitwise equal (tolerance: none). Median
   times over 20 launches, CUDA events.
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
   of the detection program and the kernel's time at the served shape
   beside its bound.

The line before the last is the kernel summary; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a card.
"""
from __future__ import annotations

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
# f32 ops per evaluated (i, j) pair of the scan (4 for ix, 4 for iy, 2 for
# inter, 4 for the IoU, 1 compare) and per box for corners and area
OPS_PER_PAIR, OPS_PER_BOX = 15, 12

SHAPES = [(1, 1), (8, 16), (64, 100), (4, 1024)]
KINDS = ["random", "ties", "degenerate", "all_suppressed", "max_keep", "score_thresh"]
# 1024 requests, so that p99 has 10 samples beyond it; 64 distinct scenes
REQUESTS_PER_CLIENT, CLIENTS, SCENES, IMG = 128, 8, 64, 416


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def make_case(kind: str, B: int, N: int, seed: int = 0):
    """-> (boxes (B, N, 4) f32, scores (B, N) f32, iou_thresh, score_thresh,
    max_keep), the same case kinds as tests/test_torch_detect.py."""
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
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    return boxes, scores.astype(np.float32), iou, sthr, mk


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


def scan_bound_ms(keep_s, N: int) -> tuple[float, str]:
    """Least time for the scan on these inputs: the bytes it must move (boxes
    and valid in, keep out) over HBM rate, or the f32 ops these inputs need
    (one IoU per later box for each box still kept at its step) over the f32
    peak, whichever is larger."""
    B = keep_s.shape[0]
    nbytes = B * N * (16 + 4 + 4)
    kept_pos = keep_s.nonzero()[:, 1]
    pairs = int((N - 1 - kept_pos).sum())
    ops = OPS_PER_PAIR * pairs + OPS_PER_BOX * B * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    from repro_torch import device as D
    from repro_torch.configs import get_arch
    from repro_torch.core import detection, serving
    from repro_torch.core.rounds import FedConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build, detect, ops, ref
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
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.library()
    print(f"phase1 build nms.cu (sm_90a, -fmad=false): {time.perf_counter() - t0:.3f} s; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: kernel vs plain on the card ---------------------------
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
            k_ms = time_ms(lambda: detect.nms_keep(boxes_s, valid_s, iou))
            p_ms = time_ms(lambda: ref.nms_keep(boxes_s, valid_s, iou))
            n_cases += 1
            print(f"phase2 {kind:14s} B={B:3d} N={N:5d} kept={int(kern.sum()):5d} bitwise-equal "
                  f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}  [{card}]", flush=True)

    # ---- phase 3: the detection service at full width -------------------
    cfg = get_arch("fedyolov3")
    fed = FedConfig(n_clients=1)  # serve_batch 8, serve_max_detections 16
    model = FedYOLOv3(cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    slot = serving.ModelSlot()
    slot.publish(1, model)
    n_req = REQUESTS_PER_CLIENT * CLIENTS
    imgs, _ = synthetic.scene_images(np.random.default_rng(7), SCENES + 8, IMG, cfg.vocab_size)
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
        nms_device_ms = None
        if rows:
            dev_ms = sum(r[0] for r in rows)
            prof_note = (f"device kernel time {dev_ms:.4f} ms per batch of {batch_ms:.4f} ms "
                         f"(idle share {1 - dev_ms / batch_ms:.3f})")
            for ms, cnt, key in rows[:10]:
                print(f"phase3 profile {ms:9.4f} ms/batch x{cnt:3d}  {key[:100]}", flush=True)
            nms_rows = [r for r in rows if "nms_keep_kernel" in r[2]]
            check(len(nms_rows) == 1 and nms_rows[0][1] == 1,
                  "the profile shows no single nms_keep_kernel launch per batch")
            nms_device_ms = nms_rows[0][0]
            print(f"phase3 profile nms_keep_kernel device time {nms_device_ms * 1e3:.2f} us "
                  f"per batch", flush=True)
        print(f"phase3 profile: {prof_note}  [{card}]", flush=True)

        # the kernel at the served shape, on the served inputs
        _, scores_k, _, shifted = detection.candidates(model, batch, fed.serve_max_detections)
        _, boxes_s, valid_s = ref.sort_by_score(shifted, scores_k, detection.SCORE_THRESH)
        keep_k = detect.nms_keep(boxes_s, valid_s, 0.5)
        keep_p = ref.nms_keep(boxes_s, valid_s, 0.5)
        torch.cuda.synchronize()
        check(same_bits(keep_k, keep_p), "served-shape scan: kernel != plain")
        max_abs_err = float((keep_k - keep_p).abs().max())
        nms_ms = time_ms(lambda: detect.nms_keep(boxes_s, valid_s, 0.5), reps=50)
        plain_ms = time_ms(lambda: ref.nms_keep(boxes_s, valid_s, 0.5), reps=50)
        bound_ms, bound_by = scan_bound_ms(keep_k, boxes_s.shape[1])

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
          f"nms_kernel_ms_per_batch={nms_ms:.5f} nms_plain_ms={plain_ms:.5f} "
          f"nms_bound_ms={bound_ms:.3e} ({bound_by})  [{card}]", flush=True)

    print(json.dumps({"kernels": [{
        "name": "nms_keep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nms.cu",
        "replaces": "src/repro/kernels/detect.py:173",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": nms_ms,
        "device_ms": nms_device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "impl": "cuda",
        "held_against": "ref",
        "cases": n_cases,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

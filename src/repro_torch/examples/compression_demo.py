"""Upload-compression demo: Eq. 6 layer selection and the bytes each
transport moves (port of ``examples/compression_demo.py``).

    PYTHONPATH=src python -m repro_torch.examples.compression_demo [--device cpu]

Shows, for one federated eq6 round of the reduced qwen3-1.7b (3 clients, 2
local adamw steps at 3e-3, top-1 upload, batch 2 of 32 tokens), which layer
buckets each client would upload under Eq. 6 and how many bytes each
transport moves: the mechanism behind the paper's Fig. 8 and its bandwidth
claim. Then the packed engine's one bucket reduce (K1) over the round state
and the legacy per-leaf path, ``kernels.ops.fedavg_tree``, which launches
K11 once per leaf. :func:`report` is the demo's tail on a given state, so a
caller can run it on any eq6 state (``chip_smoke.py`` runs it at full
width). ``--device`` defaults to ``cuda``: the kernels launch on the card
and their plain versions run on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs import get_arch
from repro_torch.core import compression as comp
from repro_torch.core import packing
from repro_torch.core import rounds as R
from repro_torch.core.rounds import FedConfig
from repro_torch.data.pipeline import fed_batches
from repro_torch.kernels import ops
from repro_torch.kernels import pack as kpack
from repro_torch.models.params import count_params, flatten_with_paths, map_tree
from repro_torch.optim import adamw

CFG = get_arch("qwen3-1.7b").reduced()
FED = FedConfig(n_clients=3, local_steps=2, aggregation="eq6", topn=1, client_axis="data",
                data_axis=None, agg_impl="kernel")
LR, BATCH, SEQ = 3e-3, 2, 32


def report(cfg, fed: FedConfig, prev_sums: torch.Tensor, state: dict, *,
           log: Callable[[str], None] = print) -> dict[str, Any]:
    """The demo's tail on an eq6 ``state`` whose round started from
    ``prev_sums``: the Eq. 6 scores and upload masks, the bytes per
    transport, one K1 launch over the packed state and ``fedavg_tree`` (one
    K11 launch per leaf) over the client-stacked tree. Prints the reference's lines
    and returns {"scores" (C, B), "masks" (C, B) bool, "uploaded" elements,
    "stacked" tree, "leaf_masks" tree, "weights" (C,), "agg" tree}."""
    C = fed.n_clients
    scores = comp.contribution_scores(prev_sums, state["agg"]["prev_sums"])
    masks = comp.topn_mask(scores, fed.topn)
    nb = comp.n_score_buckets(cfg)
    log(f"{cfg.name}: {nb} layer buckets ({cfg.n_layers} layers + misc)")
    for c in range(C):
        sc = scores[c].cpu().numpy()
        ranked = np.argsort(-sc)
        log(f"client {c}: v(j)={np.round(sc, 3)} -> uploads buckets "
            f"{np.nonzero(masks[c].cpu().numpy())[0].tolist()} (rank order {ranked.tolist()})")

    tpl = R.make_template(cfg)
    n = count_params(tpl)
    full = n * 4
    ratio = comp.compression_ratio(cfg, fed.topn)
    log(f"\nupload per client per round ({n/1e6:.1f}M params):")
    log(f"  full f32        : {full/1e6:8.2f} MB")
    log(f"  Eq.6 top-{fed.topn}      : {full*ratio/1e6:8.2f} MB")
    log(f"  int8 delta      : {n/1e6:8.2f} MB (+{nb*4} B scales)")
    log(f"  Eq.6 + int8     : {n*ratio/1e6:8.2f} MB")

    # the flat engine: state["params"] IS the packed (C, N_total) buffer; the
    # unpack below is the checkpoint/serve edge copy
    packed = state["params"]
    w = R.uniform_weights(C).to(packed.device)
    spec = packing.build_pack_spec(cfg, tpl)
    wmask = masks.float() * w[:, None]
    _, den = kpack.packed_bucket_reduce(packed, wmask.contiguous(),
                                        packing.bucket_ids_on(spec, packed.device))
    uploaded = int(torch.count_nonzero(den > 0))
    del den
    stacked = R.unpacked_params(cfg, fed, state)
    n_leaves = len(list(flatten_with_paths(stacked)))
    log(f"\nflat engine: {n_leaves} tensors live as one ({packed.shape[0]}, {packed.shape[1]}) "
        f"round-state buffer, 1 kernel launch (legacy tree path: {n_leaves} launches); "
        f"{uploaded}/{spec.n_total} elements uploaded this round")

    # the legacy per-leaf kernel path (K11), kept as the reference
    leaf_masks = map_tree(lambda _: torch.ones(C, device=packed.device), stacked)
    agg = ops.fedavg_tree(stacked, w, leaf_masks)
    leaves = [x for _, x in flatten_with_paths(agg)]
    log(f"legacy fedavg_tree aggregated {len(leaves)} tensors "
        f"({sum(x.numel() for x in leaves)/1e6:.1f}M values)")
    return {"scores": scores, "masks": masks, "uploaded": uploaded, "stacked": stacked,
            "leaf_masks": leaf_masks, "weights": w, "agg": agg}


def run_round(cfg, fed: FedConfig, dev: torch.device):
    """One eq6 round of ``cfg`` from a state drawn from seed 0 on ``dev``, on
    the demo's first batch -> (prev_sums before, state after)."""
    opt = adamw(LR)
    state = R.make_state(cfg, fed, opt, torch.Generator(device=dev).manual_seed(0), dev)
    fr = R.build_fed_round(cfg, fed, opt)
    batch = R.to_device(next(fed_batches(cfg, fed, batch=BATCH, seq=SEQ)), dev)
    before = state["agg"]["prev_sums"]
    state, _ = fr(state, batch, R.uniform_weights(fed.n_clients).to(dev))
    return before, state


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)
    cfg = dataclasses.replace(CFG, attention_impl="kernel", ssm_impl="kernel")
    before, state = run_round(cfg, FED, dev)
    return report(cfg, FED, before, state)


if __name__ == "__main__":
    main()

"""The yardstick's counts: each configuration's model FLOPs a sample
(``portbench/flops/<config>.py``) against ``torch.utils.flop_counter`` on
the ``meta`` device, and against the port's op counter
(``launch/op_analysis.py``) over a whole round of the cell, which counts the
checkpointed recompute too; K1's and K10's work (``portbench/yardstick.py``)
against their formulas in the port's ``kernels/costs.py``."""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import yardstick  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import rounds  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.models import params as mp  # noqa: E402
from repro_torch.models import transformer, yolov3  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402

CELLS = {"fedyolov3": "scenes416_c3_b8", "mamba2-1.3b": "tokens2k_c2_b4"}


def _flops(config: str):
    spec = importlib.util.spec_from_file_location(f"flops_{config}", ROOT / "portbench" / "flops"
                                                  / f"{config}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(config: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())


def _mix(config: str) -> dict:
    return json.loads((ROOT / "portbench" / "traffic" / f"{CELLS[config]}.json").read_text())


def _cfg(config: str):
    c = _config(config)
    return dataclasses.replace(get_arch(c["arch"]), **c["sizes"], **c["overrides"])


def _meta(tpl):
    return mp.map_tree(lambda i: torch.empty(i.shape, device="meta"), tpl)


def test_yolo_forward_count_is_the_flop_counters():
    """fedyolov3 at 416: 17.19 GFLOP an image, exact (tolerance 0: both
    count each convolution's multiply-adds twice)."""
    cfg = _cfg("fedyolov3")
    with FlopCounterMode(display=False) as fc:
        yolov3.forward(_meta(yolov3.template(cfg)), torch.empty((1, 416, 416, 3), device="meta"), cfg)
    ours = _flops("fedyolov3").forward_flops(_config("fedyolov3")["sizes"], {"img_size": 416})
    assert ours == fc.get_total_flops() == 17_192_075_264


def test_mamba2_forward_count_is_the_flop_counters():
    """mamba2-1.3b at 1024 tokens on the plain SSD path: 2.905 TFLOP, exact
    (tolerance 0: the same products, counted alike)."""
    cfg = dataclasses.replace(_cfg("mamba2-1.3b"), ssm_impl="ref")
    tokens = torch.zeros((1, 1024), dtype=torch.int32, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        transformer.loss_fn(cfg, _meta(transformer.template(cfg)), {"tokens": tokens})
    ours = _flops("mamba2-1.3b").forward_flops(_config("mamba2-1.3b")["sizes"], {"seq": 1024})
    assert ours == fc.get_total_flops() == 2_905_478_266_880


@pytest.mark.parametrize("config", sorted(CELLS))
def test_model_flops_sit_below_the_op_counters_round(config):
    """A whole round of the cell on ``meta``, counted by the port's op
    counter (the kernels' own reports included): it holds every client's
    forward and backward and, for the LM, each layer's recompute, so the
    model FLOPs of the round's samples sit below it. fedyolov3 recomputes
    nothing: its products are the model's, to rounding (1e-9); mamba2's
    recompute adds about one forward: between 70% and 80% of it."""
    cfg, mix, sizes = _cfg(config), _mix(config), _config(config)["sizes"]
    C, E, b = mix["clients"], mix["local_steps"], mix["batch"]
    fed = rounds.FedConfig(n_clients=C, aggregation=mix["agg"], topn=mix["topn"],
                           client_axis="data", data_axis=None, agg_impl="kernel")
    opt = sgd(1e-3) if mix["optimizer"]["name"] == "sgd" else adamw(3e-3)
    state = rounds.state_template(cfg, fed, opt, torch.float32)
    if cfg.family == "yolo":
        img, grids = mix["img_size"], yolov3.grid_sizes(cfg, mix["img_size"])
        A, K = cfg.n_heads, cfg.vocab_size
        batch = {"images": torch.empty((C, E, b, img, img, 3), device="meta"),
                 "targets": [{"obj": torch.empty((C, E, b, s, s, A), device="meta"),
                              "box": torch.empty((C, E, b, s, s, A, 4), device="meta"),
                              "cls": torch.empty((C, E, b, s, s, A, K), device="meta")}
                             for s in grids]}
    else:
        batch = {"tokens": torch.zeros((C, E, b, mix["seq"]), dtype=torch.int32, device="meta")}
    fed_round = rounds.build_fed_round(cfg, fed, opt)
    _, counted = op_analysis.count(fed_round, state, batch, rounds.uniform_weights(C))
    ours = _flops(config).flops_per_sample(sizes, mix) * C * E * b
    share = ours / counted.total_flops
    if cfg.family == "yolo":
        assert share == pytest.approx(1.0, rel=1e-9)
    else:
        assert 0.70 <= share <= 0.80


def test_k1_bytes_leave_the_bucket_ids_out():
    """K1's yardstick is the port's count less the (N,) int32 ids (exact)."""
    C, N, nb = 2, 1_343_548_416, 49
    assert yardstick.k1_bytes(C, N, nb) == costs.packed_bucket_reduce(C, N, nb)[2] - 4 * N


def test_k10_work_is_the_ports_formula():
    """K10's products and bytes at the cell's shape are the port's
    ``costs.ssd_chunk_scan`` (exact), and its least time is bound by bytes
    there."""
    shape = dict(B=4, S=2048, H=64, P=64, N=128, Q=128)
    products, _, nbytes = costs.ssd_chunk_scan(4, 2048, 64, 64, 128, 128, 4)
    assert yardstick.k10_work(**shape) == (products, nbytes)
    assert yardstick.k10_least_s(shape) == nbytes / yardstick.PEAK_BYTES

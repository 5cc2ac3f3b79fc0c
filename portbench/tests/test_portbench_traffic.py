"""The traffic copies are seeded (the same seed gives the same bytes,
another seed others); the harness finds a configuration, mix and metric
added as files, with no code edited; and without a card, or without the
port beside it, the command fails and prints no result."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _pb_tiny import ROOT, TINY, make_root, run_cell  # noqa: E402

from portbench.traffic import scenes, tokens  # noqa: E402

torch.set_num_threads(2)


def _mix(cell: str) -> tuple[dict, dict]:
    _, base, mix_name, sizes, traffic = TINY[cell]
    conf = json.loads((ROOT / "portbench" / "configs" / f"{base}.json").read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{mix_name}.json").read_text())
    return {**mix, **traffic}, {**conf["sizes"], **sizes}


def _bytes(pool: list) -> bytes:
    out = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, list):
            for v in x:
                walk(v)
        else:
            out.append(x.contiguous().numpy().tobytes())

    walk(pool)
    return b"".join(out)


@pytest.mark.parametrize("cell,gen", [("ty", scenes), ("tm", tokens)])
def test_the_same_seed_gives_the_same_bytes(cell, gen):
    mix, sizes = _mix(cell)
    seed = 2**31 + 12345  # seeds past 32 signed bits
    a, b = (_bytes(gen.pool(mix, sizes, seed, "cpu")) for _ in range(2))
    assert a == b
    assert _bytes(gen.pool(mix, sizes, seed + 1, "cpu")) != a


@pytest.mark.parametrize("cell,gen", [("ty", scenes), ("tm", tokens)])
def test_every_round_of_a_pool_differs(cell, gen):
    mix, sizes = _mix(cell)
    rounds = [_bytes([r]) for r in gen.pool(mix, sizes, 3, "cpu")]
    assert len(set(rounds)) == len(rounds) == mix["pool_rounds"]


def test_files_added_alone_make_a_new_cell(tmp_path):
    """A configuration, a mix, a FLOPs file, a limit set and a per-layer
    metric, each a new file, with entries in ``BENCHMARK.json``: the harness
    runs the new cell and reports the new metric."""
    root = make_root(tmp_path)
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "tiny-yolo.json").read_text())
    conf["sizes"]["d_model"] = 4
    (pb / "configs" / "tinier-yolo.json").write_text(json.dumps(conf))
    shutil.copy(pb / "flops" / "tiny-yolo.py", pb / "flops" / "tinier-yolo.py")
    mix = json.loads((pb / "traffic" / "ty.json").read_text())
    mix["img_size"] = 16
    (pb / "traffic" / "scenes16.json").write_text(json.dumps(mix))
    shutil.copy(pb / "limits" / "ty.json", pb / "limits" / "new_cell.json")
    (pb / "metrics" / "traced_rounds.py").write_text(
        "def read(rec):\n    return float(len(rec['rounds']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinier-yolo", "source": "test", "reduced": ["d_model"],
                             "file": "portbench/configs/tinier-yolo.json", "why": "test"})
    bench["workloads"].append({"name": "new_cell", "config": "tinier-yolo", "traffic": "scenes16",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "traced_rounds", "unit": "count", "better": "higher",
                               "source": "program_span", "layer": "round loop",
                               "moves": "train_samples_per_s", "workloads": ["new_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell(root, "new_cell", trace=1)
    assert out["correct"] is True
    assert out["metrics"]["traced_rounds"] == {"value": float(mix["trace_rounds"]), "unit": "count"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _cli(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "yolo_eq6_c3_b8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_benchmark_files_alone_print_no_result(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and the benchmark's
    folder: no port to measure, so a non-zero exit and no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""

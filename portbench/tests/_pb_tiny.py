"""Small cells for the benchmark's CPU tests: a copy of ``BENCHMARK.json``
and ``portbench/`` in a temporary root, with two cells at sizes a test can
hold, each added the way a later change adds one: a configuration file, a
mix, a FLOPs file, a limit set and ``BENCHMARK.json`` entries."""
import io
import json
import shutil
import sys
from contextlib import redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# gaps that sound runs on the CPU stay far below (their readings are about
# 1e-5 and under); the tests' own limits, not the cells'
LIMITS = {"loss_gap": 1e-4, "first_update_gap": 1e-3, "change_gap": 1e-3}
TINY = {
    "ty": ("tiny-yolo", "fedyolov3", "scenes416_c3_b8",
           {"d_model": 8, "n_layers": 3}, {"img_size": 32, "batch": 2, "clients": 2,
                                            "pool_rounds": 5, "trace_rounds": 2}),
    "tm": ("tiny-mamba2", "mamba2-1.3b", "tokens2k_c2_b4",
           {"d_model": 64, "n_layers": 2, "vocab_size": 300, "ssm_state": 16, "ssm_headdim": 16,
            "ssm_chunk": 8}, {"seq": 32, "batch": 2, "topn": 1, "pool_rounds": 5}),
}


def make_root(tmp: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp / "portbench"
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for cell, (config, base, mix, sizes, traffic) in TINY.items():
        conf = json.loads((pb / "configs" / f"{base}.json").read_text())
        conf["sizes"].update(sizes)
        (pb / "configs" / f"{config}.json").write_text(json.dumps(conf))
        shutil.copy(pb / "flops" / f"{base}.py", pb / "flops" / f"{config}.py")
        m = json.loads((pb / "traffic" / f"{mix}.json").read_text())
        m.update(traffic)
        (pb / "traffic" / f"{cell}.json").write_text(json.dumps(m))
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
        bench["configs"].append({"name": config, "source": "test", "reduced": list(sizes),
                                 "file": f"portbench/configs/{config}.json", "why": "test"})
        bench["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1,
                                   "why": "test"})
        for metric in bench["per_layer"]:
            metric["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_cell(root: Path, cell: str, seed: int = 3_000_000_001, trace: int = 0) -> dict:
    """One CPU run of ``cell`` -> its result line, parsed."""
    from portbench import run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace",
                       str(trace)], device="cpu", root=root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])

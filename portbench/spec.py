"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``portbench/`` a file per configuration
(``configs/<config>.json``), traffic mix (``traffic/<mix>.json``), model
FLOPs (``flops/<config>.py``), per-layer metric (``metrics/<metric>.py``)
and cell limit set (``limits/<cell>.json``). Adding any of these is adding
a file and an entry; no code names them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict
    root: Path

    def flops_per_sample(self) -> float:
        mod = load_module(self.root / "portbench" / "flops" / f"{self.config['name']}.py")
        return mod.flops_per_sample(self.config["sizes"], self.mix)

    def metric_reader(self, name: str):
        return load_module(self.root / "portbench" / "metrics" / f"{name}.py").read


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    config["name"] = conf["name"]
    mix = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    return Cell(workload, w["chips"], config, mix,
                [m for m in bench["end_to_end"] if _in_cell(m, workload)],
                [m for m in bench["per_layer"] if _in_cell(m, workload)], limits, root)

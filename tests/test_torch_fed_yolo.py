"""The port's ``fed_yolo`` runner (``repro_torch.examples.fed_yolo``) held
against the reference's ``examples/fed_yolo.py``.

Both run at a small size: fedyolov3 cut to base width 8 and 3 stages (each
example's ``get_arch`` pointed at it), 32x32 scenes, 6 rounds, mAP at
rounds 0 and 5. The port's server starts from the reference server's
initial state, carried by ``models.convert.state_from_reference`` (eq6's
state rebuilt from it). Tolerances:

- the printed mapped-file count, the dirichlet split line and the COS
  rounds: exact;
- the loss trajectory: rtol 1e-5, and the participants exactly (the
  bounds of ``tests/test_torch_train_rounds.py``'s server rounds);
- the mAP trajectory: atol 1e-6, as ``tests/test_torch_train_rounds.py`` holds
  ``evaluate_round``.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import numpy as np

import jax

from repro.configs import get_arch as jget_arch
from repro_torch.configs import get_arch
from repro_torch.core.server import FLServer
from repro_torch.examples import fed_yolo
from repro_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]
JCFG = dataclasses.replace(jget_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
TCFG = dataclasses.replace(get_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
ARGS = ["--rounds", "6", "--img-size", "32", "--eval-every", "5"]


def _reference_example():
    spec = importlib.util.spec_from_file_location("reference_fed_yolo", ROOT / "examples" / "fed_yolo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fed_yolo_matches_reference_example(monkeypatch, capsys):
    ref = _reference_example()
    servers = []

    class Recorded(ref.FLServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.initial = jax.tree.map(np.array, self.state)  # before donation
            servers.append(self)

    monkeypatch.setattr(ref, "get_arch", lambda name: JCFG)
    monkeypatch.setattr(ref, "FLServer", Recorded)
    monkeypatch.setattr(sys, "argv", ["fed_yolo", *ARGS])
    ref.main()
    ref_lines = capsys.readouterr().out.splitlines()
    (jsrv,) = servers

    class Carried(FLServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            p, o = convert.state_from_reference(TCFG, jsrv.initial["params"], jsrv.initial["opt"])
            self.state = {"params": p, "opt": o, "agg": self.aggregator.init_state(p), "round": 0}

    monkeypatch.setattr(fed_yolo, "get_arch", lambda name: TCFG)
    monkeypatch.setattr(fed_yolo, "FLServer", Carried)
    lines = []
    res = fed_yolo.main(["--device", "cpu", *ARGS], log=lines.append)

    for prefix in ("annotation module mapped", "dirichlet scene split"):
        ours = [ln for ln in lines if ln.startswith(prefix)]
        assert ours and ours == [ln for ln in ref_lines if ln.startswith(prefix)], prefix
    cos = [ln.split(", total")[0] for ln in ref_lines if ln.startswith("COS stored rounds")]
    assert cos == [f"COS stored rounds: {res['stored_rounds']}"] and res["stored_rounds"] == [0, 5]
    assert res["mapped"] == 4
    srv = res["server"]
    assert [r.participants for r in srv.history] == [r.participants for r in jsrv.history]
    np.testing.assert_allclose(res["losses"], [r.loss for r in jsrv.history], rtol=1e-5)
    assert res["losses"][-1] < res["losses"][0]
    assert [e.round_idx for e in srv.eval_history] == [e.round_idx for e in jsrv.eval_history]
    for e, je in zip(srv.eval_history, jsrv.eval_history):
        np.testing.assert_allclose(e.map50, je.map50, atol=1e-6)
        np.testing.assert_allclose(e.per_client_map, je.per_client_map, atol=1e-6)
    assert any(ln.startswith("serving 4 frames") for ln in lines)

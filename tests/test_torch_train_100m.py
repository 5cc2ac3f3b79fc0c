"""The port's ``train_100m`` example (``repro_torch.examples.train_100m``)
held against the reference's ``examples/train_100m.py``.

Both run at a small size: each example's ``arch_100m`` pointed at the
reduced granite-3-8b (2 layers, d_model 256, vocab 512), the examples'
defaults otherwise (4 clients, batch 2 of 128 tokens, eq6 top-4, adamw
3e-4), 3 rounds, and each example's ``FLServer`` subclassed to checkpoint
every round. The port's server starts from the reference server's initial
state, carried by ``models.convert.state_from_reference`` (eq6's state
rebuilt from it). Tolerances:

- ``arch_100m`` itself: the reference's config field for field, and its
  parameter count;
- the printed arch line, the JSON keys (the port adds ``device``), the
  participants and the COS rounds: exact;
- the loss trajectory: rtol 1e-5 (``tests/test_torch_fed_yolo.py``'s bound).
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import numpy as np

import jax

from repro.configs import get_arch as jget_arch
from repro.core import rounds as jrounds
from repro.models import params as jparams
from repro_torch.configs import get_arch
from repro_torch.core.rounds import make_template
from repro_torch.core.server import FLServer
from repro_torch.examples import train_100m
from repro_torch.models import convert
from repro_torch.models.params import count_params

ROOT = Path(__file__).resolve().parents[1]
JCFG = jget_arch("granite-3-8b").reduced()
TCFG = get_arch("granite-3-8b").reduced()
ROUNDS = 3


def _reference_example():
    spec = importlib.util.spec_from_file_location("reference_train_100m",
                                                  ROOT / "examples" / "train_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_arch_100m_is_the_references():
    ref = _reference_example()
    assert dataclasses.asdict(train_100m.arch_100m()) == dataclasses.asdict(ref.arch_100m())
    n = count_params(make_template(train_100m.arch_100m()))
    assert n == jparams.count_params(jrounds.make_template(ref.arch_100m())) == 87_516_800


def test_train_100m_matches_reference_example(monkeypatch, capsys, tmp_path):
    ref = _reference_example()
    servers = []

    class Recorded(ref.FLServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "checkpoint_every": 1})
            self.initial = jax.tree.map(np.array, self.state)  # before donation
            servers.append(self)

    monkeypatch.setattr(ref, "arch_100m", lambda: JCFG)
    monkeypatch.setattr(ref, "FLServer", Recorded)
    monkeypatch.setattr(sys, "argv", ["train_100m", "--rounds", str(ROUNDS), "--store",
                                      str(tmp_path / "ref")])
    ref.main()
    ref_lines = capsys.readouterr().out.splitlines()
    want = json.loads(ref_lines[-1])
    (jsrv,) = servers

    class Carried(FLServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "checkpoint_every": 1})
            p, o = convert.state_from_reference(TCFG, jsrv.initial["params"], jsrv.initial["opt"])
            self.state = {"params": p, "opt": o, "agg": self.aggregator.init_state(p), "round": 0}

    monkeypatch.setattr(train_100m, "arch_100m", lambda: TCFG)
    monkeypatch.setattr(train_100m, "FLServer", Carried)
    lines = []
    res = train_100m.main(["--device", "cpu", "--rounds", str(ROUNDS), "--store",
                           str(tmp_path / "port")], log=lines.append)

    assert lines[0] == ref_lines[0] and lines[0].startswith("arch=")
    got = json.loads(lines[-1])
    assert list(got) == [*want, "device"] and got["device"] == "cpu"
    for k in ("params_M", "rounds", "cos_rounds"):
        assert got[k] == want[k], k
    assert got["cos_rounds"] == list(range(ROUNDS))
    srv = res["server"]
    assert [r.participants for r in srv.history] == [r.participants for r in jsrv.history]
    np.testing.assert_allclose([r.loss for r in srv.history], [r.loss for r in jsrv.history],
                               rtol=1e-5)
    np.testing.assert_allclose([got["loss_first"], got["loss_last"]],
                               [want["loss_first"], want["loss_last"]], atol=1e-4)

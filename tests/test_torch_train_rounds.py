"""The port's training rounds (``repro_torch``: the flat state carried
across, two flat rounds, ``FLServer`` rounds and evaluation, and the
launcher) held against the reference on identical inputs; the loss, the
optimizers, K1 and the aggregators alone are ``tests/test_torch_train.py``'s,
whose configuration (fedyolov3 cut to base width 8 and 3 stages, 32x32
images, 3 clients) and helpers this file shares.

Both packages start from the reference's own initial state, carried across
by ``models.convert.state_from_reference``; data comes from the same NumPy
seeds. Tolerances, each stated where it is used: whole rounds, loss rtol
1e-5, params atol 1e-6 / rtol 1e-4 (gradient differences after two local
steps and two rounds, measured max 5e-8 on weights of size 0.6); the
carried state and the edge unpack: bitwise.
"""
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import packing as jpacking
from repro.core import rounds as jrounds
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.scheduler import TaskScheduler as JTaskScheduler
from repro.core.server import FLServer as JFLServer
from repro.data import pipeline as jpipeline
from repro.models import params as jparams
from repro.models import yolov3 as jyolo
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.core import rounds
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.core.server import FLServer
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import convert, params
from repro_torch.optim import sgd
from test_torch_train import C, IMG, JCFG, TCFG, _fed, _spec


# ------------------------------ state and rounds ----------------------------

def test_state_carry_over_round_trips_bit_exact():
    jspec = jpacking.build_pack_spec(JCFG, jyolo.template(JCFG))
    rng = np.random.default_rng(3)
    stacked = jax.tree.map(lambda i: rng.normal(size=(C,) + i.shape).astype(np.float32),
                           jyolo.template(JCFG), is_leaf=jparams.is_info)
    packed = np.asarray(jpacking.pack(jspec, stacked))
    for jopt in (jsgd(1e-2), jadamw(1e-3), jsgd(1e-2, momentum=0.0)):
        # the reference's client-stacked optimizer state, moments made non-zero
        opt = jax.tree.map(lambda x: np.asarray(x) + 0.5, jax.vmap(jopt.init)(stacked))
        p, o = convert.state_from_reference(TCFG, packed, opt)
        assert p.shape == (C, _spec().n_total)
        assert all(v.shape in ((C, _spec().n_total), (C,)) for v in o.values())
        back_p, back_o = convert.state_to_reference(TCFG, p, o)
        np.testing.assert_array_equal(back_p, packed)
        ref_leaves, ref_def = jax.tree.flatten(opt)
        ours_leaves, ours_def = jax.tree.flatten(back_o)
        assert ours_def == ref_def
        for a, b in zip(ours_leaves, ref_leaves):
            np.testing.assert_array_equal(a, b)
        if "mu" in o:  # a moment's row is the reference's tree, packed
            np.testing.assert_array_equal(o["mu"].numpy(), np.asarray(jpacking.pack(jspec, opt["mu"])))
    # the edge helper: the flat state's client-stacked HWIO tree
    ours = rounds.unpacked_params(TCFG, _fed("torch"), {"params": torch.tensor(packed)})
    ref = jrounds.unpacked_params(JCFG, _fed("jax"), {"params": jnp.asarray(packed)})
    for (path, a), (_, b) in zip(params.flatten_with_paths(ours),
                                 params.flatten_with_paths(jax.tree.map(np.asarray, ref))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


def _carried_state(st):
    p, o = convert.state_from_reference(TCFG, np.asarray(st["params"]),
                                        jax.tree.map(np.asarray, st["opt"]))
    agg = {k: torch.tensor(np.asarray(v)) for k, v in st["agg"].items()}
    return {"params": p, "opt": o, "agg": agg, "round": int(st["round"])}


@pytest.mark.parametrize("participation", ["full", "masked"])
def test_two_flat_rounds_match_reference(participation):
    jfed, tfed = _fed("jax", participation=participation), _fed("torch", participation=participation)
    st = jax.jit(lambda k: jrounds.make_state(JCFG, jfed, jsgd(1e-2), k))(jax.random.key(0))
    tstate = _carried_state(st)
    jround = jax.jit(jrounds.build_fed_round(JCFG, jfed, jsgd(1e-2)))
    tround = rounds.build_fed_round(TCFG, tfed, sgd(1e-2))
    gen, _, _ = jpipeline.detection_suite(JCFG, jfed, batch=2, img_size=IMG, pool_scenes=24)
    masks = [np.array([1, 0, 1], np.float32), np.array([0, 1, 1], np.float32)]
    for r in range(2):
        b = next(gen)
        if participation == "full":  # a bare weight vector: mask None
            jpart, tpart = jnp.asarray(rounds.uniform_weights(C).numpy()), rounds.uniform_weights(C)
        else:
            m = masks[r]
            jpart = jrounds.participation_input(jfed, m, m / m.sum())
            tpart = rounds.participation_input(tfed, m, m / m.sum())
        st, jm = jround(st, jax.tree.map(jnp.asarray, b), jpart)
        tstate, tm = tround(tstate, rounds.to_device(b, "cpu"), tpart)
        assert tstate["round"] == int(st["round"]) == r + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["client_loss"].numpy(), np.asarray(jm["client_loss"]), rtol=1e-5)
        if participation == "masked":  # a client that sat out reports loss 0
            assert (tm["client_loss"].numpy()[masks[r] == 0] == 0).all()
        np.testing.assert_allclose(tstate["params"].numpy(), np.asarray(st["params"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tstate["agg"]["prev_sums"].numpy(),
                                   np.asarray(st["agg"]["prev_sums"]), rtol=1e-5, atol=1e-4)
        _, mu = convert.state_to_reference(TCFG, tstate["params"], tstate["opt"])
        for a, b_ in zip(jax.tree.leaves(mu), jax.tree.leaves(st["opt"])):
            np.testing.assert_allclose(a, np.asarray(b_), rtol=1e-4, atol=1e-5)


def test_server_rounds_match_reference():
    sched = dict(max_participants=2, fairness_rounds=2)
    jfed, tfed = _fed("jax", participation="masked"), _fed("torch", participation="masked")
    jsrv = JFLServer(JCFG, jfed, jsgd(1e-2), seed=0,
                     scheduler=JTaskScheduler(C, JSchedulerConfig(**sched)))
    srv = FLServer(TCFG, tfed, sgd(1e-2), seed=0, device="cpu",
                   scheduler=TaskScheduler(C, SchedulerConfig(**sched)))
    srv.state = _carried_state(jsrv.state)
    jgen, jev, _ = jpipeline.detection_suite(JCFG, jfed, batch=2, img_size=IMG, pool_scenes=24)
    gen, ev, _ = pipeline.detection_suite(TCFG, tfed, batch=2, img_size=IMG, pool_scenes=24)
    for _ in range(3):
        jrec = jsrv.run_round(jax.tree.map(jnp.asarray, next(jgen)))
        rec = srv.run_round(next(gen))
        assert rec.participants == jrec.participants
        assert rec.weights == jrec.weights and rec.loads == jrec.loads
        np.testing.assert_allclose(rec.loss, jrec.loss, rtol=1e-5)
    # mAP of the global model on the holdout: the two decodes see weights
    # 1e-6 apart, which leaves ranking, NMS and matching unchanged here
    jrec, rec = jsrv.evaluate_round(jev, max_detections=16), srv.evaluate_round(ev, max_detections=16)
    assert rec.round_idx == jrec.round_idx == 2
    np.testing.assert_allclose(rec.map50, jrec.map50, atol=1e-6)
    np.testing.assert_allclose(rec.per_client_map, jrec.per_client_map, atol=1e-6)
    np.testing.assert_allclose(srv.scheduler.quality, jsrv.scheduler.quality, rtol=1e-4, atol=1e-4)
    # the dispatchable global model is row 0 in the reference's layout
    glob = convert.to_reference(srv.global_params())
    for (path, a), (_, b) in zip(params.flatten_with_paths(glob),
                                 params.flatten_with_paths(jax.tree.map(np.asarray,
                                                                        jsrv.global_params()))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=path)


# ------------------------------ launcher ------------------------------------

def test_launcher_trains_evaluates_checkpoints_and_serves(tmp_path, capsys):
    summary = train.main(["--task", "detection", "--device", "cpu", "--rounds", "6", "--clients", "3",
                          "--img-size", "32", "--batch", "2", "--participation", "masked",
                          "--max-participants", "2", "--fairness-rounds", "3", "--optimizer", "sgd",
                          "--lr", "1e-3", "--topn", "4", "--eval-every", "5",
                          "--store", str(tmp_path / "cos")])
    out = capsys.readouterr().out
    assert summary["rounds"] == 6 and np.isfinite(summary["final_loss"])
    assert summary["stored_rounds"] == [0, 5]
    assert summary["served_version"] == 6
    assert 0.0 <= summary["final_map"] <= 1.0 and len(summary["per_client_map"]) == 3
    assert out.count("mAP@0.5") >= 3  # rounds 0 and 5 and the monitor's line
    assert '"final_loss"' in out.splitlines()[-1]


# the launcher's socket wire and its durability (slice 5), on the host: a
# run of the reduced qwen3-1.7b over 2 worker processes' clients, each with
# one intra-op thread
SOCKET_RUN = ["--device", "cpu", "--arch", "qwen3-1.7b", "--clients", "2", "--buffer-size", "1",
              "--rounds", "2", "--batch", "1", "--seq", "8"]


def _reference_json_keys(function: str) -> set:
    """The keys of the JSON dict the reference launcher's ``function``
    prints, read from its source (running it would start JAX workers)."""
    import ast
    import inspect

    from repro.launch import train as jtrain

    tree = ast.parse(inspect.getsource(getattr(jtrain, function)))
    return {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict) for k in node.keys}


@pytest.mark.parametrize("flags", [["--mode", "async", "--transport", "socket"],
                                   ["--transport", "socket"], ["--restore", "x"],
                                   ["--mode", "async", "--record-schedule", "x"]],
                         ids=["socket", "socket-needs-async", "restore", "record-inproc"])
def test_launcher_paths_of_slice_5(flags, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    record = tmp_path / "run.schedule.json"
    if flags == ["--transport", "socket"]:  # the reference's ap.error, as a ValueError
        with pytest.raises(ValueError, match="pass --mode async"):
            train.main(["--device", "cpu", *flags])
        return
    if flags[0] == "--restore":
        durable = tmp_path / "run"
        run = train.main([*SOCKET_RUN, "--mode", "async", "--transport", "socket", "--rounds", "3",
                          "--durable-dir", str(durable), "--snapshot-every", "1",
                          "--fault-plan", "kill@2"])
        assert run["recovered"] and run["rounds"] == 3 and not run["deadline_hit"]
        assert "CRASHED" in capsys.readouterr().out
        got = train.main(["--device", "cpu", "--restore", str(durable)])
        assert set(got) == _reference_json_keys("_restore") | {"device"}
        assert got["version"] == 3 and got["wal_events"] == run["wal_events"] > 0
        assert got["events_replayed"] <= 1 and got["staged_window"] == []
        return
    if "--transport" not in flags:  # in process: the reference writes no schedule either
        got = train.main([*SOCKET_RUN, *flags[:-2], "--record-schedule", str(record)])
        assert got["mode"] == "async" and got["rounds"] == 2 and not record.exists()
        return
    got = train.main([*SOCKET_RUN, *flags, "--wire-codec", "quant8",
                      "--record-schedule", str(record)])
    out = capsys.readouterr().out
    assert set(got) == _reference_json_keys("_run_socket") | {"device"}
    assert (got["rounds"], got["landed"], got["wire_codec"]) == (2, 2, "quant8")
    assert not got["deadline_hit"] and got["bytes_up"] > 0 and got["device"] == "cpu"
    assert "  wire     2 flushes   2 landed / 0 dropped" in out
    again = train.main(["--device", "cpu", "--replay-schedule", str(record)])
    assert again["flushes"] == 2 and again["deterministic"]
    np.testing.assert_allclose(again["final_loss"], got["final_loss"], rtol=1e-6)


def test_launcher_parsers_take_the_reference_flags_and_defaults(monkeypatch):
    """Every flag of the reference launcher with its default, choices and
    type, ``--print-plan`` included (the launch tooling), plus the port's
    ``--device`` and ``--seed``."""
    import argparse
    import sys

    from repro.launch import train as jtrain

    class Grabbed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        raise Grabbed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        m.setattr(sys, "argv", ["train"])
        with pytest.raises(Grabbed) as ei:
            jtrain.main()
    ref = ei.value.args[0]

    def flags(parser):
        return {a.option_strings[-1]: (a.dest, a.default, a.choices and list(a.choices), a.type,
                                        a.nargs, a.const, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    ours, theirs = flags(train.build_parser()), flags(ref)
    assert set(ours) - set(theirs) == {"--device", "--seed"}
    assert set(theirs) - set(ours) == set()
    for k in set(ours) & set(theirs):
        assert ours[k] == theirs[k], k

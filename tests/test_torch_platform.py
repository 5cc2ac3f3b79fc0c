"""The port's multi-task platform (``repro_torch.core.{task_manager, client,
explorer, monitor}``, ``FLServer`` on a shared ``SimClock``, and the two
examples) held against the reference on identical inputs.

The task manager, the client, the Explorer's draws, the monitor's views and
the simulated clock are host Python and NumPy in both packages: the same
scripted tasks and seeds give the same execution order, statuses, clock
readings, draws, lines and JSON keys (tolerance: none). The servers start
from the reference's own initial state, carried across by
``models.convert``; data comes from the same NumPy seeds. Rounds are held at
the whole-round tolerance of ``tests/test_torch_train_rounds.py``: the loss at
rtol 1e-5. The models are fedyolov3 cut to base width 8 and 3 stages at
32x32 (as ``tests/test_torch_train.py``) and qwen3-1.7b reduced (2 layers,
d_model 256, as ``tests/test_torch_lm_train.py``).
"""
import contextlib
import dataclasses
import io
import json
from types import SimpleNamespace

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import async_engine as jae
from repro.core import client as jclient
from repro.core import explorer as jexplorer
from repro.core import monitor as jmonitor
from repro.core import rounds as jrounds
from repro.core import serving as jserving
from repro.core import server as jserver
from repro.core import simclock as jsimclock
from repro.core import task_manager as jtm
from repro.data import pipeline as jpipeline
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.configs import get_arch
from repro_torch.core import async_engine as ae
from repro_torch.core import client, explorer, monitor, rounds, serving, server, simclock
from repro_torch.core import task_manager as tm_mod
from repro_torch.data import pipeline
from repro_torch.examples import multi_task_platform as mtp
from repro_torch.examples import quickstart
from repro_torch.models import convert
from repro_torch.optim import adamw, sgd

JCFG = dataclasses.replace(jget_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
TCFG = dataclasses.replace(get_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
IMG = 32

PKGS = {
    "ref": SimpleNamespace(TaskManager=jtm.TaskManager, FederatedTask=jtm.FederatedTask,
                           SimClock=jsimclock.SimClock),
    "port": SimpleNamespace(TaskManager=tm_mod.TaskManager, FederatedTask=tm_mod.FederatedTask,
                            SimClock=simclock.SimClock),
}


def _carried(cfg, st) -> dict:
    """The reference's flat round state -> the port's, same numbers."""
    p, o = convert.state_from_reference(cfg, np.asarray(st["params"]),
                                        jax.tree.map(np.asarray, st["opt"]))
    agg = convert.agg_state_from_reference(jax.tree.map(np.asarray, st["agg"]))
    return {"params": p, "opt": o, "agg": agg, "round": int(st["round"])}


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture
def jit_ref_state(monkeypatch):
    """The reference server's initial state made by one jitted program
    instead of op by op (about 15 s of eager compiles on a CPU): the same
    state is then carried into the port, so only its cost changes."""
    make = jrounds.make_state

    def jitted(cfg, fed, opt, key, dtype=jnp.float32):
        return jax.jit(lambda k: make(cfg, fed, opt, k, dtype))(key)

    monkeypatch.setattr(jrounds, "make_state", jitted)


# ------------------------------ task manager ---------------------------------

def _raised(fn) -> tuple[str, str] | None:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the trace compares what was raised
        return type(e).__name__, str(e)
    return None


def _trace(tm, order, clock=None) -> dict:
    return {"order": order,
            "status": {k: t.status.value for k, t in tm.tasks.items()},
            "rounds_done": {k: t.rounds_done for k, t in tm.tasks.items()},
            "history": {k: t.history for k, t in tm.tasks.items()},
            "clock": clock.now() if clock is not None else None}


def _runs_to_completion(P):
    tm, order = P.TaskManager(), []

    def mk(tid, total):
        return P.FederatedTask(tid, "qwen3-1.7b", total,
                               lambda r: order.append((tid, r)) or {"round": r})

    tm.register(mk("a", 3))
    tm.register(mk("b", 5))
    tm.run_to_completion()
    return _trace(tm, order)


def _isolates_failures(P):
    tm, order = P.TaskManager(), []

    def boom(r):
        order.append(("bad", r))
        raise RuntimeError("client died")

    tm.register(P.FederatedTask("bad", "x", 2, boom))
    tm.register(P.FederatedTask("good", "x", 1, lambda r: order.append(("good", r)) or {}))
    out = tm.step_all()  # the failure's own report, then the rest of the run
    tm.run_to_completion()
    return {**_trace(tm, order), "first_pass": out}


def _rejects_duplicates(P):
    tm = P.TaskManager()
    tm.register(P.FederatedTask("t", "x", 1, lambda r: {}))
    return {**_trace(tm, []),
            "raised": _raised(lambda: tm.register(P.FederatedTask("t", "x", 1, lambda r: {})))}


def _interleaves_on_shared_clock(P):
    """An 'async' task (event-queue ETAs) and a sync task (now + round
    period) advance in simulated-completion order, not round-robin."""
    clock, order = P.SimClock(), []

    def mk(tid, durations):
        times = iter(durations)
        pending = [None]

        def nt():
            if pending[0] is None:
                pending[0] = clock.now() + next(times)
            return pending[0]

        def run(r):
            t = nt()
            clock.advance_to(t)
            pending[0] = None
            order.append((tid, t))
            return {"round": r, "t": t}

        return P.FederatedTask(tid, "x", len(durations), run, next_time=nt)

    tm = P.TaskManager(clock=clock)
    tm.register(mk("async", [10.0, 15.0, 30.0]))  # flushes at t=10, 25, 55
    tm.register(mk("sync", [20.0, 20.0]))  # rounds at t=20, 40
    tm.run_to_completion()
    trace = _trace(tm, order, clock)
    tm.register(P.FederatedTask("untimed", "x", 1, lambda r: {}))
    return {**trace, "raised": _raised(tm.step_shared_clock)}


def _without_clock_keeps_fair_share(P):
    tm, calls = P.TaskManager(), []
    tm.register(P.FederatedTask("a", "x", 2, lambda r: calls.append("a") or {}))
    tm.register(P.FederatedTask("b", "x", 2, lambda r: calls.append("b") or {}))
    tm.run_to_completion()
    return {**_trace(tm, calls), "raised": _raised(tm.step_shared_clock)}


@pytest.mark.parametrize("scenario", [_runs_to_completion, _isolates_failures,
                                      _rejects_duplicates, _interleaves_on_shared_clock,
                                      _without_clock_keeps_fair_share],
                         ids=lambda f: f.__name__.strip("_"))
def test_task_manager_matches_reference(scenario):
    ref, port = scenario(PKGS["ref"]), scenario(PKGS["port"])
    assert port == ref
    # and the reference tests' own expectations hold on the port
    if scenario is _runs_to_completion:
        assert port["rounds_done"] == {"a": 3, "b": 5} and set(port["status"].values()) == {"done"}
    elif scenario is _isolates_failures:
        assert port["status"] == {"bad": "failed", "good": "done"}
        assert port["first_pass"]["bad"] == {"error": "client died"}
    elif scenario is _rejects_duplicates:
        assert port["raised"] == ("ValueError", "duplicate task id t")
    elif scenario is _interleaves_on_shared_clock:
        assert [o[0] for o in port["order"]] == ["async", "sync", "async", "sync", "async"]
        assert port["clock"] == pytest.approx(55.0)
        assert port["raised"][0] == "RuntimeError" and "next_time" in port["raised"][1]
    else:
        assert port["order"] == ["a", "b", "a", "b"]  # lockstep round-robin
        assert port["raised"][0] == "RuntimeError" and "SimClock" in port["raised"][1]


# ------------------------------ explorer and client --------------------------

def test_explorer_matches_reference():
    assert [f.name for f in dataclasses.fields(explorer.ResourceReport)] == \
        [f.name for f in dataclasses.fields(jexplorer.ResourceReport)]
    base = explorer.ResourceReport(0.45, 0.3, 1.0, 0.0)
    jbase = jexplorer.ResourceReport(0.45, 0.3, 1.0, 0.0)
    for n, seed in [(8, 0), (3, 7), (1024, 1)]:
        for b, jb in [(None, None), (base, jbase)]:
            a = explorer.simulated_loads(n, np.random.default_rng(seed), b)
            r = jexplorer.simulated_loads(n, np.random.default_rng(seed), jb)
            assert a.shape == (n,) and a.dtype == r.dtype and np.array_equal(a, r)
            assert (a >= 0).all() and (a <= 1).all()
    assert explorer._read_cpu_times()[0] >= explorer._read_cpu_times()[1] > 0
    rep = explorer.monitor(0.01)
    assert 0.0 <= rep.cpu_frac <= 1.0 and 0.0 <= rep.mem_frac <= 1.0 and rep.load1 >= 0
    assert rep.timestamp > 0


def test_client_matches_reference():
    ops = ["drop", "reconnect", "drop", "drop", "reconnect", "drop", "reconnect", "drop"]

    def run(mod, cid, max_reconnects):
        c = mod.FLClient(mod.ClientConfig(cid, max_reconnects=max_reconnects))
        seq = [c.resource_report() for _ in range(6)]
        for op in ops:
            seq.append((op, getattr(c, op)(), c.connected, c.reconnects))
        with pytest.raises(RuntimeError, match="no data pipeline"):
            c.next_batch()
        fed = mod.FLClient(mod.ClientConfig(cid), data=iter([{"x": 1}, {"x": 2}]),
                           rng=np.random.default_rng(99))
        seq += [fed.next_batch(), fed.next_batch(), fed.resource_report(), fed.cfg.max_reconnects]
        return seq

    for cid, budget in [(0, 2), (1, 2), (5, 0), (2, 3)]:
        got, want = run(client, cid, budget), run(jclient, cid, budget)
        assert got == want
        assert all(0.0 <= x <= 0.8 for x in got[:6])


# ------------------------------ monitor ---------------------------------------

def _status(mod, fed, latest, now, traffic):
    slot = mod.ModelSlot()
    slot.publish(3, None, t=0.0)
    stats = mod.ServeStats(requests=16, results=16, batches=3, occupancy_sum=16) if traffic else None
    return mod.model_status(slot, latest, now, fed, stats)


@pytest.mark.parametrize("traffic", [False, True], ids=["idle", "traffic"])
@pytest.mark.parametrize("tier,latest,now", [("fresh", 4, 12.5), ("soft_stale", 6, 12.5),
                                             ("hard_stale", 3, 700.0)])
def test_render_serving_line_for_line(tier, latest, now, traffic):
    st = _status(serving, rounds.FedConfig(n_clients=2), latest, now, traffic)
    jst = _status(jserving, jrounds.FedConfig(n_clients=2), latest, now, traffic)
    assert st == jst and st["tier"] == tier
    got = monitor.render_serving("fedyolov3", st)
    assert got == jmonitor.render_serving("fedyolov3", jst)
    assert len(got.splitlines()) == (3 if traffic else 2)


def _records(mod, rec_mod, kind, n_clients):
    if kind == "async":
        hist = [rec_mod.AsyncRoundRecord(
            round_idx=i, loss=2.0 - 0.1 * i, weights=[0.5, 0.5] + [0.0] * (n_clients - 2),
            seconds=0.1 * (i + 1), participants=[0, 1], loads=[0.2] * n_clients, version=i + 1,
            sim_time=30.0 * (i + 1) + 0.25, staleness=[0, i], dropped=i % 2) for i in range(3)]
    else:
        hist = [mod.RoundRecord(i, 5.0 - 0.1 * i, [1.0 / (c + 1) if (c + i) % 3 else 0.0
                                                   for c in range(n_clients)], 0.3 + i,
                                participants=[0], loads=[0.1] * n_clients) for i in range(4)]
    evals = None
    if kind.startswith("eval"):
        rng = np.random.default_rng(n_clients)
        evals = [mod.EvalRecord(i, 0.1 * i, [float(x) for x in rng.random(n_clients)])
                 for i in range(3)]
    return hist, evals


@pytest.mark.parametrize("kind,n_clients,cap", [("sync", 3, 16), ("async", 3, 16),
                                                ("eval_under_cap", 5, 16),
                                                ("eval_over_cap", 20, 16),
                                                ("eval_uncapped", 20, 0)])
def test_export_json_key_for_key(kind, n_clients, cap):
    hist, evals = _records(server, ae, kind, n_clients)
    jhist, jevals = _records(jserver, jae, kind, n_clients)
    got = monitor.export_json("demo", hist, n_clients, eval_history=evals, per_client_cap=cap)
    want = jmonitor.export_json("demo", jhist, n_clients, eval_history=jevals, per_client_cap=cap)
    assert got == want
    data = json.loads(got)
    if kind == "async":
        assert data["rounds"][-1]["sim_time"] == pytest.approx(90.25)
        assert data["rounds"][-1]["staleness"] == [0, 2] and data["rounds"][-1]["dropped"] == 0
    if kind == "eval_over_cap":
        assert len(data["eval"][0]["per_client_top"]) == cap
        assert data["eval"][0]["per_client_capped"] == n_clients
    if kind in ("eval_under_cap", "eval_uncapped"):
        assert len(data["eval"][0]["per_client_map"]) == n_clients
    assert monitor.render_task("demo", hist, n_clients, eval_history=evals) == \
        jmonitor.render_task("demo", jhist, n_clients, eval_history=jevals)


# ------------------------------ the server on a shared clock -----------------

def _ref_fed(fed):
    """The reference's FedConfig of a port task (its jnp aggregation path)."""
    return jrounds.FedConfig(**{**dataclasses.asdict(fed), "agg_impl": "ref"})


def test_sync_server_on_a_shared_clock_matches_reference(jit_ref_state):
    """The platform's detector task (dense, C 2, sgd 1e-3) on a shared clock,
    on the reference's 1 x 1 mesh as its example runs it."""
    tfed = mtp.fed_configs()[1]
    jfed = _ref_fed(tfed)
    jclock, clock = jsimclock.SimClock(), simclock.SimClock()
    mesh = _mesh()
    with jax.set_mesh(mesh):
        jsrv = jserver.FLServer(JCFG, jfed, jsgd(1e-3), mesh=mesh, seed=0, clock=jclock)
    srv = server.FLServer(TCFG, tfed, sgd(1e-3), seed=0, device="cpu", clock=clock)
    assert srv.clock is clock and srv._shared_clock
    srv.state = _carried(TCFG, jsrv.state)
    jgen = jpipeline.fed_batches(JCFG, jfed, batch=2, seq=0, img_size=IMG)
    gen = pipeline.fed_batches(TCFG, tfed, batch=2, seq=0, img_size=IMG)
    before = 0.0
    for _ in range(2):
        assert srv.next_time() == jsrv.next_time()
        with jax.set_mesh(mesh):
            jrec = jsrv.run_round(jax.tree.map(jnp.asarray, next(jgen)))
        rec = srv.run_round(next(gen))
        assert clock.now() == jclock.now() > before
        assert srv.load_model.t == jsrv.load_model.t == clock.now()
        assert rec.participants == jrec.participants
        assert rec.weights == jrec.weights and rec.loads == jrec.loads
        np.testing.assert_allclose(rec.loss, jrec.loss, rtol=1e-5)
        before = clock.now()
    # without a clock, sync rounds keep the timeless cadence
    plain = server.FLServer(TCFG, tfed, sgd(1e-3), seed=0, device="cpu")
    plain.run_round(next(gen))
    assert plain.clock.now() == 0.0 and plain.load_model.t == 1.0


# ------------------------------ the slice as a whole -------------------------

@pytest.fixture(scope="module")
def lm_cfgs():
    return jget_arch("qwen3-1.7b").reduced(), get_arch("qwen3-1.7b").reduced()


def _drops(clients, tm, rng):
    """The reference example's loop, over either package's objects."""
    passes, drops = 0, []
    while tm.runnable():
        victim = clients[rng.integers(0, len(clients))]
        if rng.random() < 0.3 and victim.connected:
            alive = victim.drop()
            drops.append(f"client {victim.cfg.client_id} dropped "
                         f"({'will reconnect' if alive else 'out of reconnect budget'})")
        tm.step_all()
        passes += 1
    return passes, drops


def test_two_task_platform_matches_reference(lm_cfgs, jit_ref_state):
    """The example's two tasks at a tiny size: a yolo task (dense, C 2, img
    32, batch 2) and an LM task (eq6 top-2, C 3, adamw 3e-3, batch 2 of
    32), 2 rounds each under one Task Manager, weights carried across."""
    jlm_cfg, lm_cfg = lm_cfgs
    fed_lm, fed_yolo = mtp.fed_configs()
    jfed_lm, jfed_yolo = _ref_fed(fed_lm), _ref_fed(fed_yolo)
    mesh = _mesh()
    with jax.set_mesh(mesh):
        jlm = jserver.FLServer(jlm_cfg, jfed_lm, jadamw(3e-3), mesh=mesh, seed=0)
        jyolo = jserver.FLServer(JCFG, jfed_yolo, jsgd(1e-3), mesh=mesh, seed=0)
        lm = server.FLServer(lm_cfg, fed_lm, adamw(3e-3), seed=0, device="cpu")
        yolo = server.FLServer(TCFG, fed_yolo, sgd(1e-3), seed=0, device="cpu")
        lm.state, yolo.state = _carried(lm_cfg, jlm.state), _carried(TCFG, jyolo.state)

        def batches(mod, cfg, fed, **kw):
            return mod.fed_batches(cfg, fed, batch=2, **kw)

        jtmgr, tmgr = jtm.TaskManager(), tm_mod.TaskManager()
        for mgr, pkg, srvs, gens in [
                (jtmgr, "ref", (jlm, jyolo),
                 (map(lambda b: jax.tree.map(jnp.asarray, b),
                      batches(jpipeline, jlm_cfg, jfed_lm, seq=32)),
                  map(lambda b: jax.tree.map(jnp.asarray, b),
                      batches(jpipeline, JCFG, jfed_yolo, seq=0, img_size=IMG)))),
                (tmgr, "port", (lm, yolo),
                 (batches(pipeline, lm_cfg, fed_lm, seq=32),
                  batches(pipeline, TCFG, fed_yolo, seq=0, img_size=IMG)))]:
            P = PKGS[pkg]
            for tid, srv, gen in zip(("lm", "yolo"), srvs, gens):
                run = (mtp.task_round(srv, gen, tid) if pkg == "port"
                       else (lambda r, srv=srv, gen=gen: vars(srv.run_round(next(gen)))))
                mgr.register(P.FederatedTask(tid, tid, 2, run))
        jclients = [jclient.FLClient(jclient.ClientConfig(i, max_reconnects=2)) for i in range(3)]
        clients = [client.FLClient(client.ClientConfig(i, max_reconnects=2)) for i in range(3)]
        jpasses, jdrops = _drops(jclients, jtmgr, np.random.default_rng(0))
        passes, drops = mtp.drive(tmgr, clients, np.random.default_rng(0), log=lambda m: None)
    assert passes == jpasses == 2 and drops == jdrops
    assert [(c.reconnects, c.connected) for c in clients] == \
        [(c.reconnects, c.connected) for c in jclients]
    for tid in ("lm", "yolo"):
        t, jt = tmgr.tasks[tid], jtmgr.tasks[tid]
        assert t.status.value == jt.status.value == "done"
        assert t.rounds_done == jt.rounds_done == 2
        for h, jh in zip(t.history, jt.history):
            assert h["participants"] == jh["participants"] and h["weights"] == jh["weights"]
            np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5, err_msg=tid)
    # the secure sidebar over the LM's client trees (the example's function)
    assert mtp.secure_error(lm) <= 1e-3


# ------------------------------ the examples ---------------------------------

def test_quickstart_runs_and_its_loss_falls():
    lines = []
    out = quickstart.main(["--device", "cpu", "--rounds", "3"], log=lines.append)
    assert len(out["losses"]) == 3 and out["losses"][-1] < out["losses"][0]
    assert 1 <= out["mean_participants"] <= 3
    assert lines[-1].startswith("\nfederated loss") and "(eq6, mean participants" in lines[-1]
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            quickstart.main(["--rounds", "1"])
    assert "fedsgd" not in quickstart.build_parser()._option_string_actions["--agg"].choices


def test_multi_task_platform_at_the_references_settings():
    out_io = io.StringIO()
    with contextlib.redirect_stdout(out_io):
        out = mtp.main(["--device", "cpu"])
    printed = out_io.getvalue()
    lm, yolo = out["servers"]["lm"], out["servers"]["yolo"]
    assert out["passes"] == 8 and len(lm.history) == 8 and len(yolo.history) == 6
    assert all(t.status == tm_mod.TaskStatus.DONE for t in out["tm"].tasks.values())
    assert lm.cfg == get_arch("qwen3-1.7b").reduced() and yolo.cfg == get_arch("fedyolov3")
    for tid, n in (("lm", 8), ("yolo", 6)):
        assert out["views"][tid] in printed
        assert out["views"][tid].splitlines()[0] == f"[{tid}] round {n}/{n} complete"
    assert "TaskManager finished both tasks in 8 fair-share passes" in printed
    assert out["secure_err"] <= 1e-3 and "secure aggregation: pairwise masks cancel" in printed
    for d in out["drops"]:
        assert d in printed
    assert all(np.isfinite(r.loss) for r in lm.history + yolo.history)
    # the monitor's JSON feed reads both histories back
    for tid, srv in out["servers"].items():
        data = json.loads(monitor.export_json(tid, srv.history, srv.fed.n_clients))
        assert [r["round"] for r in data["rounds"]] == list(range(len(srv.history)))

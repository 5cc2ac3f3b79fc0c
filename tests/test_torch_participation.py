"""The port's compact participation, fedsgd topology and sharded client axis
held against the reference (``tests/test_participation.py``,
``tests/test_fed.py``, ``tests/test_hier.py`` mirrored side by side).

The model is the reduced qwen3-1.7b the reference's tests use, C = 4
clients, sgd lr 0.05; both packages start from the reference's own state,
carried across by ``models.convert``, and tokens come from NumPy seeds. The
reference runs on its (1, 1) mesh, the port on its launcher's 1 x 1 client
mesh (a one-rank gloo group). Tolerances, each stated where it is used:

- compact rounds against the reference: the reference's rtol 1e-6 /
  atol 1e-7 (``tests/test_participation.py``) on params, losses and client
  losses. quant8 rounds: the two packages' local training differs by about
  1e-7 relative, which flips a rounding decision that sits that close to a
  half step; at most 1 element in 10^4 may then differ, by at most one
  weighted quantization step (0.5 s; s at most 1.9e-4 measured, so 1e-4);
- compact against masked and K = C against full, inside the port: bitwise
  (the same rows train on the same batches; an all-ones mask is None);
- fedsgd against the reference's fedsgd: the LM sgd round's params rtol
  1e-4 / atol 1e-5 and loss rtol 1e-5 (``tests/test_torch_lm_train_rounds.py``);
  against the stacked dense E = 1 round: the reference's rtol 2e-4 /
  atol 2e-5 (``tests/test_fed.py``);
- 2 ranks over gloo against one shard: the reference's pin
  (``tests/test_hier.py``), relative max gap below 1e-6 and loss gap below
  1e-6; the observed gap is printed (0 expected: every rank runs the same
  arithmetic on the same rows). The gathered int8 payload: bitwise.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import rounds as JR
from repro.models import transformer as jT
from repro.optim import sgd as jsgd
from repro_torch.configs import get_arch
from repro_torch.core import packing, rounds
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.core.server import FLServer
from repro_torch.data.pipeline import fed_batches
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.models.params import map_tree
from repro_torch.optim import sgd

JCFG = jget_arch("qwen3-1.7b").reduced()
TCFG = get_arch("qwen3-1.7b").reduced()
SEED_MODES = ["dense", "eq6", "quant8", "static_topn"]
C = 4
ROOT = Path(__file__).resolve().parents[1]


def _fed(pkg, mode, **kw):
    base = dict(n_clients=C, local_steps=1, aggregation=mode, topn=2, client_axis="data",
                data_axis=None)
    base.update(kw)
    return (rounds.FedConfig if pkg == "torch" else JR.FedConfig)(**base)


def _toks(seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (C, 1, 2, 16)).astype(np.int32)


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _ref_state(fed, seed=0):
    with jax.set_mesh(_jmesh()):
        return jax.tree.map(np.asarray, JR.make_state(JCFG, fed, jsgd(lr=0.05), jax.random.key(seed)))


def _carried(st):
    p, o = convert.state_from_reference(TCFG, st["params"], st["opt"])
    return {"params": p, "opt": o, "agg": convert.agg_state_from_reference(st["agg"]), "round": 0}


def _port_round(fed, st, part, toks=None, mesh=None):
    state = _carried(st)
    fr = rounds.build_fed_round(TCFG, fed, sgd(lr=0.05), mesh)
    return fr(state, {"tokens": torch.from_numpy(_toks() if toks is None else toks)}, part)


def _same(a, b):
    assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------ compact against the reference ----------------------

@pytest.mark.parametrize("mode", SEED_MODES)
def test_compact_round_matches_reference(mode):
    """K = 2 with idx [0, 2], on the port's 1-rank mesh and the reference's
    (1, 1) mesh: the same params, losses and client losses; the unselected
    clients report loss 0 and keep their optimizer rows bit for bit."""
    mask = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    w, idx = mask / mask.sum(), np.array([0, 2])
    jf = _fed("jax", mode, participation="compact", max_participants=2)
    st0 = _ref_state(jf)
    with jax.set_mesh(_jmesh()):
        st1, jm = jax.jit(JR.build_fed_round(JCFG, jf, jsgd(lr=0.05), _jmesh()))(
            jax.tree.map(jnp.asarray, st0), {"tokens": jnp.asarray(_toks())},
            JR.participation_input(jf, mask, w, idx))
    tf = _fed("torch", mode, participation="compact", max_participants=2)
    ts, tm = _port_round(tf, st0, rounds.participation_input(tf, mask, w, idx),
                         mesh=train.client_mesh(torch.device("cpu")))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(tm["client_loss"].numpy(), np.asarray(jm["client_loss"]), rtol=1e-6)
    assert tm["client_loss"][1] == 0.0 and tm["client_loss"][3] == 0.0
    mu0 = convert.state_from_reference(TCFG, st0["params"], st0["opt"])[1]["mu"]
    _same(ts["opt"]["mu"][[1, 3]], mu0[[1, 3]])
    a, b = ts["params"].numpy(), np.asarray(st1["params"])
    off = ~np.isclose(a, b, rtol=1e-6, atol=1e-7)
    print(f"{mode}: {int(off.sum())} of {a.size} params off rtol 1e-6 / atol 1e-7, "
          f"max abs gap {np.abs(a - b).max():.3e}")
    if mode == "quant8":
        assert off.sum() <= 1e-4 * a.size
        np.testing.assert_allclose(a[off], b[off], rtol=0, atol=1e-4)
    else:
        assert not off.any()


def test_unselected_clients_keep_their_rows():
    """static_topn with topn 0 uploads nothing, so the dispatch is each
    client's own row: the unselected rows come back bit for bit."""
    mask = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    tf = _fed("torch", "static_topn", topn=0, participation="compact", max_participants=2)
    st0 = _ref_state(_fed("jax", "dense"))
    ts, _ = _port_round(tf, st0, rounds.participation_input(tf, mask, mask / 2, [0, 2]))
    p0 = torch.tensor(st0["params"])
    _same(ts["params"][[1, 3]], p0[[1, 3]])
    assert not torch.equal(ts["params"][0], p0[0]) and not torch.equal(ts["params"][2], p0[2])


def test_full_budget_compact_matches_full():
    st0 = _ref_state(_fed("jax", "dense"))
    full, mf = _port_round(_fed("torch", "dense"), st0, rounds.uniform_weights(C))
    fc = _fed("torch", "dense", participation="compact", max_participants=C)
    comp, mc = _port_round(fc, st0, rounds.participation_input(fc, np.ones(C), np.full(C, 0.25),
                                                               np.arange(C)))
    _same(full["params"], comp["params"])
    _same(mf["client_loss"], mc["client_loss"])


@pytest.mark.parametrize("mode", SEED_MODES)
def test_masked_and_compact_agree_on_partial_selection(mode):
    mask = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    w = mask / mask.sum()
    st0 = _ref_state(_fed("jax", mode))
    fm = _fed("torch", mode, participation="masked")
    fc = _fed("torch", mode, participation="compact", max_participants=2)
    sm, mm = _port_round(fm, st0, rounds.participation_input(fm, mask, w))
    sc, mc = _port_round(fc, st0, rounds.participation_input(fc, mask, w, np.array([0, 2])))
    _same(sm["params"], sc["params"])
    _same(mm["client_loss"], mc["client_loss"])
    assert float(mm["client_loss"][1]) == 0.0 and float(mm["client_loss"][3]) == 0.0


def test_participation_validation():
    with pytest.raises(ValueError, match="full|masked|compact"):
        rounds.build_fed_round(TCFG, _fed("torch", "dense", participation="nope"), sgd())
    with pytest.raises(ValueError, match="fedsgd"):
        rounds.build_fed_round(TCFG, _fed("torch", "fedsgd", participation="masked"), sgd())
    with pytest.raises(ValueError, match="max_participants"):
        rounds.build_fed_round(TCFG, _fed("torch", "dense", participation="compact",
                                          max_participants=C + 1), sgd())
    fc = _fed("torch", "dense", participation="compact", max_participants=2)
    with pytest.raises(ValueError, match="idx"):
        rounds.participation_input(fc, np.ones(C), np.full(C, 0.25))
    with pytest.raises(ValueError, match="exactly K"):
        rounds.participation_input(fc, np.ones(C), np.full(C, 0.25), np.arange(3))
    with pytest.raises(ValueError, match="duplicate"):
        rounds.participation_input(fc, np.ones(C), np.full(C, 0.25), np.array([1, 1]))
    with pytest.raises(ValueError, match="not a dim of the mesh"):
        rounds.make_aggregator(TCFG, _fed("torch", "quant8", client_axis="pod"),
                               train.client_mesh(torch.device("cpu")))
    state = rounds.make_state(TCFG, fc, sgd(), device="cpu")
    with pytest.raises(ValueError, match="bare weight vector"):
        rounds.build_fed_round(TCFG, fc, sgd())(state, {"tokens": torch.from_numpy(_toks())},
                                                rounds.uniform_weights(C))


def test_server_compact_end_to_end():
    fed = _fed("torch", "dense", participation="compact", max_participants=2)
    server = FLServer(TCFG, fed, sgd(lr=0.05), device="cpu",
                      scheduler=TaskScheduler(C, SchedulerConfig(max_participants=2,
                                                                 fairness_rounds=2)),
                      mesh=train.client_mesh(torch.device("cpu")))
    history = server.fit(fed_batches(TCFG, fed, batch=2, seq=16), 4, log=None)
    assert all(len(r.participants) == 2 for r in history)
    assert all(np.isfinite(r.loss) for r in history)
    # the quality EMA only ever updated for clients that took part
    seen = {c for r in history for c in r.participants}
    assert all(np.isnan(server.scheduler.last_loss[c]) for c in range(C) if c not in seen)


@pytest.mark.parametrize("flags", [["--task", "detection", "--img-size", "32", "--clients", "3"],
                                   ["--task", "lm", "--arch", "qwen3-1.7b", "--seq", "16"]])
def test_launcher_runs_compact_participation(flags):
    summary = train.main(["--device", "cpu", "--rounds", "2", "--batch", "2", "--optimizer", "sgd",
                          "--participation", "compact", "--max-participants", "2", *flags])
    assert summary["participation"] == "compact" and summary["mean_participants"] == 2
    assert np.isfinite(summary["final_loss"])


def test_client_mesh_is_built_once_and_refuses_a_group_without_its_backend():
    mesh = train.client_mesh(torch.device("cpu"))
    assert train.client_mesh("cpu") is mesh
    assert mesh.mesh_dim_names == ("data", "model") and mesh.size() == 1
    if not torch.cuda.is_available():  # the one-rank group is gloo alone
        with pytest.raises(RuntimeError, match="needs a one-rank process group with nccl"):
            train.client_mesh(torch.device("cuda"))


# ------------------------------ fedsgd ---------------------------------------

def _fedsgd_batch(toks):
    """(C, E, b, S) -> the one batch (E, C b, S) fedsgd trains on."""
    return toks.transpose(1, 0, 2, 3).reshape(toks.shape[1], -1, toks.shape[3])


def test_fedsgd_round_matches_reference():
    jf, tf = _fed("jax", "fedsgd"), _fed("torch", "fedsgd")
    with jax.set_mesh(_jmesh()):
        st0 = jax.tree.map(np.asarray, JR.make_state(JCFG, jf, jsgd(lr=0.05), jax.random.key(3)))
        st1, jm = jax.jit(JR.build_fed_round(JCFG, jf, jsgd(lr=0.05), _jmesh()))(
            jax.tree.map(jnp.asarray, st0), {"tokens": jnp.asarray(_fedsgd_batch(_toks()))},
            JR.uniform_weights(C))
    row, opt = convert.fedsgd_state_from_reference(TCFG, st0["params"], st0["opt"])
    ts, tm = rounds.build_fed_round(TCFG, tf, sgd(lr=0.05))(
        {"params": row, "opt": opt, "agg": {}, "round": 0},
        {"tokens": torch.from_numpy(_fedsgd_batch(_toks()))}, rounds.uniform_weights(C))
    want, want_mu = (convert.fedsgd_state_from_reference(TCFG, jax.tree.map(np.asarray, st1["params"]),
                                                         jax.tree.map(np.asarray, st1["opt"])))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["client_loss"].numpy(), np.asarray(jm["client_loss"]), rtol=1e-5)
    np.testing.assert_allclose(ts["params"].numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts["opt"]["mu"].numpy(), want_mu["mu"].numpy(), rtol=1e-4, atol=1e-5)
    assert ts["round"] == 1 and ts["agg"] == {}
    # the port's fedsgd state holds one shared tree
    tree = rounds.unpacked_params(TCFG, tf, ts)
    assert tree["embed"].shape == tuple(jT.template(JCFG)["embed"].shape)


def test_fedsgd_equals_stacked_dense_e1():
    """Param-averaging == gradient-averaging for E = 1 sgd, momentum 0."""
    opt = sgd(lr=0.05, momentum=0.0)
    toks = np.random.default_rng(7).integers(0, TCFG.vocab_size, (C, 1, 2, 16)).astype(np.int32)
    fa, fs = _fed("torch", "dense"), _fed("torch", "fedsgd")
    st_a = rounds.make_state(TCFG, fa, opt, torch.Generator().manual_seed(3), "cpu")
    st_s = rounds.make_state(TCFG, fs, opt, torch.Generator().manual_seed(3), "cpu")
    _same(st_a["params"][0], st_s["params"])
    st_a, _ = rounds.build_fed_round(TCFG, fa, opt)(st_a, {"tokens": torch.from_numpy(toks)},
                                                    rounds.uniform_weights(C))
    st_s, _ = rounds.build_fed_round(TCFG, fs, opt)(
        st_s, {"tokens": torch.from_numpy(_fedsgd_batch(toks))}, rounds.uniform_weights(C))
    np.testing.assert_allclose(st_a["params"][0].numpy(), st_s["params"].numpy(), rtol=2e-4,
                               atol=2e-5)


def test_fedsgd_server_trains_one_shared_copy():
    fed = _fed("torch", "fedsgd")
    server = FLServer(TCFG, fed, sgd(lr=0.05), device="cpu")
    history = server.fit(fed_batches(TCFG, fed, batch=2, seq=16), 2, log=None)
    assert all(np.isfinite(r.loss) for r in history)
    assert server.state["params"].dim() == 1 and server.state["agg"] == {}
    flat = packing.pack(server.aggregator.ctx.spec, map_tree(lambda x: x[None], server.global_params()))
    _same(flat[0], server.state["params"])


# ------------------- the sharded client axis, 2 ranks over gloo ---------------

SHARD_MODES = {"hier": dict(aggregation="hier", group_size=2, hier_base="dense"),
               "quant8": dict(aggregation="quant8"), "dense": dict(aggregation="dense"),
               "eq6": dict(aggregation="eq6")}
SHARD_WEIGHTS = [0.4, 0.1, 0.3, 0.2]
SHARD_ROUNDS = 2
# one rank of the 2-rank run (it imports no JAX): the cases' rounds from its
# row block of the reference's state, the gathered payload, the validation
# messages and a server round, written to <out>/rank<r>.npz
_SHARD_WORKER = r"""
import datetime, pickle, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
torch.set_num_threads(1)
rank, out = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(out + "/store", 2), rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_arch
from repro_torch.core import aggregators, packing, rounds
from repro_torch.core.server import FLServer
from repro_torch.data.pipeline import fed_batches
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.optim import sgd

with open(out + "/inputs.pkl", "rb") as f:  # written by this test's parent process
    inp = pickle.load(f)
cfg, C = get_arch("qwen3-1.7b").reduced(), inp["C"]
mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
res = {}
def fed(**kw):
    base = dict(n_clients=C, local_steps=1, topn=2, client_axis="data", data_axis=None,
                agg_impl="kernel")
    return rounds.FedConfig(**{**base, **kw})
for name, kw in inp["modes"].items():
    f, st = fed(**kw), inp["states"][name]
    p, o = convert.state_from_reference(cfg, st["params"], st["opt"],
                                        rows=packing.packed_pspec(C, "data", mesh))
    state = {"params": p, "opt": o, "agg": convert.agg_state_from_reference(st["agg"]), "round": 0}
    fr = rounds.build_fed_round(cfg, f, sgd(lr=0.05), mesh)
    for _ in range(inp["rounds"]):
        state, m = fr(state, {"tokens": torch.from_numpy(inp["toks"])}, torch.tensor(inp["weights"]))
    res[name + "/params"] = state["params"].numpy()
    res[name + "/loss"] = np.float32(m["loss"])
    res[name + "/client_loss"] = m["client_loss"].numpy()
# the gathered int8 payload of this rank's rows
x = torch.from_numpy(np.random.default_rng(9).normal(size=(C, 5001)).astype(np.float32))
q, s = ops.quantize_rows(x[2 * rank: 2 * rank + 2], block=1024)
f = fed(aggregation="quant8")
res["gathered/q"] = aggregators.gather_clients(q, f, mesh).numpy()
res["gathered/scales"] = aggregators.gather_clients(s, f, mesh).numpy()
# validation, with the reference's messages
def message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"
res["err/quant8"] = message(lambda: rounds.make_aggregator(cfg, fed(n_clients=3, aggregation="quant8"), mesh))
res["err/hier"] = message(lambda: rounds.make_aggregator(
    cfg, fed(n_clients=6, aggregation="hier", group_size=2), mesh))
res["err/secure"] = message(lambda: rounds.make_aggregator(cfg, fed(aggregation="secure"), mesh))
res["err/quant4"] = message(lambda: rounds.make_aggregator(cfg, fed(aggregation="quant4"), mesh))
res["err/clients"] = message(lambda: rounds.build_fed_round(cfg, fed(n_clients=3, aggregation="dense"), sgd(), mesh))
# a server round: every rank reports the same loss and dispatches row 0
f = fed(aggregation="dense", participation="masked")
server = FLServer(cfg, f, sgd(lr=0.05), device="cpu", mesh=mesh)
rec = server.run_round(next(fed_batches(cfg, f, batch=2, seq=16)))
res["server/loss"] = np.float32(rec.loss)
res["server/embed"] = server.global_params()["embed"].numpy()
np.savez(out + f"/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def _shard_fed(pkg, kw):
    return _fed(pkg, kw["aggregation"], **{k: v for k, v in kw.items() if k != "aggregation"},
                **({"agg_impl": "kernel"} if pkg == "torch" else {}))


@pytest.fixture(scope="module")
def shard_states():
    """The reference's initial state per sharded case, the start of both the
    2-rank run and the one-shard run."""
    return {name: _ref_state(_shard_fed("jax", kw)) for name, kw in SHARD_MODES.items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, shard_states):
    """Runs the 2-rank worker once for this file: 2 processes of 1 thread,
    a FileStore rendezvous (no port), a hard 300 s limit. -> per rank the
    dict of its results."""
    import pickle

    out = tmp_path_factory.mktemp("two_ranks")
    (out / "worker.py").write_text(_SHARD_WORKER)
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"C": C, "modes": SHARD_MODES, "states": shard_states, "toks": _toks(),
                     "weights": SHARD_WEIGHTS, "rounds": SHARD_ROUNDS}, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                                        os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(out / "worker.py"), str(r), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def one_shard(shard_states):
    """The same rounds on one shard (no mesh), from the same carried state."""
    res = {}
    for name, kw in SHARD_MODES.items():
        state = _carried(shard_states[name])
        fr = rounds.build_fed_round(TCFG, _shard_fed("torch", kw), sgd(lr=0.05))
        for _ in range(SHARD_ROUNDS):
            state, m = fr(state, {"tokens": torch.from_numpy(_toks())}, torch.tensor(SHARD_WEIGHTS))
        res[name] = (state["params"].numpy(), float(m["loss"]), m["client_loss"].numpy())
    return res


@pytest.mark.parametrize("mode", sorted(SHARD_MODES))
def test_two_ranks_match_one_shard(mode, two_ranks, one_shard):
    p1, l1, cl1 = one_shard[mode]
    p2 = np.concatenate([r[f"{mode}/params"] for r in two_ranks])
    gap = np.max(np.abs(p1.astype(np.float64) - p2)) / max(np.max(np.abs(p1)), 1e-9)
    print(f"{mode}: 2 ranks against one shard, relative max gap {gap:.3e}, loss gap "
          f"{abs(l1 - float(two_ranks[0][f'{mode}/loss'])):.3e}")
    assert gap < 1e-6
    for r in two_ranks:  # every rank reports the whole cohort's metrics
        assert abs(l1 - float(r[f"{mode}/loss"])) < 1e-6
        np.testing.assert_array_equal(r[f"{mode}/client_loss"], cl1)


def test_two_ranks_gather_the_int8_payload_bitwise(two_ranks):
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(C, 5001)).astype(np.float32))
    q, s = packing.quantize_rows_ref(x, 1024)
    for r in two_ranks:
        np.testing.assert_array_equal(r["gathered/q"], q.numpy())
        np.testing.assert_array_equal(r["gathered/scales"].view(np.int32), s.numpy().view(np.int32))


@pytest.mark.parametrize("case,match", [
    ("quant8", r"ValueError: quant8 requires n_clients \(3\) divisible by the 'data' mesh axis \(2 shards\)"),
    ("hier", "ValueError: hier: groups must be shard-local — n_clients=6 over 2 'data' shards "
             "leaves 3 rows per shard, not divisible by group_size=2"),
    ("secure", "ValueError: secure masking needs every client row on one host; 'data' mesh axis "
               r"must be 1 \(got 2\)"),
    ("quant4", r"ValueError: quant4 has no sharded int4 collective; 'data' mesh axis must be 1 "
               r"\(got 2\)"),
    ("clients", "ValueError: sharded client axis: n_clients=3 must be divisible by the 'data' "
                r"mesh axis \(2 shards\)"),
])
def test_two_ranks_refuse_what_cannot_shard(case, match, two_ranks):
    import re

    for r in two_ranks:
        assert re.match(match, str(r[f"err/{case}"])), str(r[f"err/{case}"])


def test_two_rank_server_reports_one_cohort(two_ranks):
    f = rounds.FedConfig(n_clients=C, local_steps=1, topn=2, client_axis="data", data_axis=None,
                         agg_impl="kernel", aggregation="dense", participation="masked")
    server = FLServer(TCFG, f, sgd(lr=0.05), device="cpu")
    rec = server.run_round(next(fed_batches(TCFG, f, batch=2, seq=16)))
    embed = server.global_params()["embed"].numpy()
    for r in two_ranks:
        assert abs(float(r["server/loss"]) - rec.loss) < 1e-6
        assert np.max(np.abs(r["server/embed"] - embed)) / np.max(np.abs(embed)) < 1e-6

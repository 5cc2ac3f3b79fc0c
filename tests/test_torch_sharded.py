"""The port's sharded model (``repro_torch``: ``core.collectives``, the
column block of ``core.packing``, the FSDP step of
``rounds.local_training``, ``rounds.aggregate_sharded``, fedsgd and the
buffered and streaming engines over a sharded client axis) on 2- and
4-rank gloo groups, held against the port's meshless runs and the
reference's.

Each mesh shape runs once for this file, its ranks as processes of one
thread over a ``FileStore`` rendezvous (no port), with a hard limit; they
start before the reference's programs compile, which run meanwhile. The
model is the reduced qwen3-1.7b narrowed to d_model 128, d_ff 256 and a
vocabulary of 256 (N_total 426,880, 3 score buckets), with a copy at
d_model 127 whose N_total (423,547) is odd, C = 4 clients,
sgd lr 0.05 (and adamw 3e-3 for one case), 2 rounds; every run starts from
the reference's initial state, carried across by ``models.convert`` (the
rank's block of it under a mesh).

Tolerances, each stated where it is used:

- against the port's meshless run: relative max gap below 1e-6 (the pin of
  ``tests/test_torch_participation.py::test_two_ranks_match_one_shard``),
  losses within 1e-6 and client losses equal. The meshless twin sums the
  same parts of the step's batch as the P data-parallel ranks do, so it
  runs with ``microbatches`` = P (a rank's part is a microbatch, and the
  ranks' sum is the microbatch loop's); the gap printed is 0 where the
  arithmetic is the same op for op;
- against the reference's meshless run of the same split (``jax`` on the
  CPU, one device, the same ``microbatches``): the bounds of
  ``tests/test_torch_lm_train_rounds.py``'s rounds, loss rtol 1e-5, params rtol
  1e-4 / atol 1e-5; under a rounding or selection mode (quant8, quant4,
  secure, topk_ef) or adamw at most 1e-4 of the elements may be further
  off, by at most one step (``_hold_reference`` says why);
- the aggregation alone on identical inputs: bitwise against the meshless
  aggregate (params and state), except eq6, whose layer sums add the
  blocks' parts: the same upload choices and values within 1e-6;
- the engines' records (participants, staleness, drops, simulated seconds,
  weights): equal to the meshless engine's;
- each rank's state bytes: the client-stacked buffers exactly the meshless
  state's divided by S M, the server rows (no client dim) by M, the rest
  whole.
"""
import dataclasses
import os
import pickle
import re
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
from repro.core import async_engine as jae
from repro.core import explorer as jexplorer
from repro.core import rounds as JR
from repro import optim as joptim
from repro_torch.configs import get_arch
from repro_torch.core import async_engine as ae
from repro_torch.core import compression as comp
from repro_torch.core import explorer, packing, rounds
from repro_torch.models import convert
from repro_torch.models.params import flatten_with_paths, map_tree
from repro_torch import optim as toptim

ROOT = Path(__file__).resolve().parents[1]
C, ROUNDS, FLUSHES = 4, 2, 4
# the reduced qwen3-1.7b narrowed, and a copy whose N_total is odd
NARROW = {"even": dict(d_model=128, d_ff=256, vocab_size=256),
          "odd": dict(d_model=127, d_ff=256, vocab_size=256)}
CFGS = {k: (dataclasses.replace(jget_arch("qwen3-1.7b").reduced(), **kw),
            dataclasses.replace(get_arch("qwen3-1.7b").reduced(), **kw)) for k, kw in NARROW.items()}
WEIGHTS = [0.4, 0.1, 0.3, 0.2]
# the 11 stacked modes
MODES = {"dense": {}, "eq6": {}, "static_topn": {}, "quant8": {},
         "quant4": dict(quant4_mode="stochastic", quant4_seed=4),
         "secure": dict(secure_domain="int8", secure_session=6), "topk_ef": dict(topk_frac=0.2),
         "hier": dict(group_size=2, hier_base="eq6"), "fedavgm": dict(server_lr=1.0),
         "fedadam": dict(server_lr=0.02), "trimmed_mean": {}}
# case -> (mode, optimizer, config, FedConfig overrides)
CASES = {**{m: (m, "sgd", "even", {}) for m in MODES},
         "eq6-adamw": ("eq6", "adamw", "even", {}),
         "dense-clip": ("dense", "sgd-clip", "even", {}),  # the clip's norm summed over blocks
         "dense-odd": ("dense", "sgd", "odd", {})}  # N_total odd: the flat dim stays whole
SHAPES = {(1, 2): sorted(CASES), (2, 2): ["dense", "eq6", "quant8"], (2, 1): []}
# state_layout="tree" rounds (sgd, the even config) on the meshes of 2 ranks
TREE_SHAPES = {(1, 2): ["dense", "eq6", "quant8"], (2, 1): ["dense", "eq6", "quant8"]}
ENGINE = dict(n_clients=C, mode="async", buffer_size=2, staleness_alpha=0.5)
ENGINES = {"buffered": ("eq6", dict(max_staleness=1)),
           "streaming": ("dense", dict(stream=True, max_staleness=2))}
BASELINE = [0.1, 0.2, 0.5, 0.6]  # client 3 lands stale, and once too stale
TIMING = dict(uplink_spread=0.5, payload_bytes=215_904.0)  # uploads short beside compute


def _fed(pkg, aggregation, **kw):
    base = dict(n_clients=C, local_steps=1, aggregation=aggregation, topn=2, client_axis="data",
                data_axis=None, **MODES.get(aggregation, {}))
    base.update(kw)
    if pkg == "torch":
        return rounds.FedConfig(agg_impl="kernel", **base)
    return JR.FedConfig(**base)


def _opts(mod):
    return {"sgd": mod.sgd(lr=0.05), "sgd-clip": mod.sgd(lr=0.05, clip_norm=0.05),
            "adamw": mod.adamw(lr=3e-3), "stream": mod.sgd(lr=0.05, momentum=0.0)}


def _toks(seed, shape=(C, 1, 2, 16)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _merged(toks):
    """(C, E, b, S) -> the one batch (E, C b, S) fedsgd trains on."""
    return np.ascontiguousarray(toks.transpose(1, 0, 2, 3).reshape(toks.shape[1], -1, toks.shape[3]))


def _load_model(mod):
    lm = mod.ClientLoadModel(C, seed=0)
    lm.baseline = np.array(BASELINE, float)
    lm.loads = lm.baseline.copy()
    return lm


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# one rank of a sharded run (it imports no JAX): every case of its mesh
# shape from its block of the reference's state, written to
# <out>/<S>x<M>/rank<r>.npz
_WORKER = r"""
import dataclasses, datetime, pickle, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
S, M, rank, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(f"{out}/store{S}x{M}", S * M), rank=rank,
                        world_size=S * M, timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_arch
from repro_torch.core import async_engine as ae, compression as comp, explorer, packing, rounds
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert
from repro_torch.models.params import flatten_with_paths, map_tree
from repro_torch.optim import adamw, sgd

with open(out + "/inputs.pkl", "rb") as f:  # written by this test's parent process
    inp = pickle.load(f)
mesh = make_host_mesh(S, M, "cpu")
C, cfgs = inp["C"], {k: dataclasses.replace(get_arch("qwen3-1.7b").reduced(), **v)
                     for k, v in inp["cfgs"].items()}
opts = {"sgd": sgd(lr=0.05), "sgd-clip": sgd(lr=0.05, clip_norm=0.05), "adamw": adamw(lr=3e-3),
        "stream": sgd(lr=0.05, momentum=0.0)}
res = {}
def fed(aggregation, **kw):
    base = dict(n_clients=C, local_steps=1, aggregation=aggregation, topn=2, client_axis="data",
                data_axis=None, agg_impl="kernel", **inp["modes"].get(aggregation, {}))
    return rounds.FedConfig(**{**base, **kw})
def message(fn):
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"
toks = torch.from_numpy(inp["toks"])
w = torch.tensor(inp["weights"])
for name in inp["shapes"][(S, M)]:
    mode, opt, cfg_name, kw = inp["cases"][name]
    cfg, f, st = cfgs[cfg_name], fed(mode, **kw), inp["states"][(opt, cfg_name)]
    agg = rounds.make_aggregator(cfg, f, mesh)
    rows, cols = packing.packed_block(C, agg.ctx.spec.n_total, "data", mesh)
    p, o = convert.state_from_reference(cfg, st["params"], st["opt"], rows=rows, cols=cols)
    a = convert.agg_state_from_reference(inp["agg"][(mode, cfg_name)],
                                         rows=rows if agg.row_state else None, cols=cols)
    state = {"params": p, "opt": o, "agg": a, "round": 0}
    fr = rounds.build_fed_round(cfg, f, opts[opt], mesh)
    for _ in range(inp["rounds"]):
        state, m = fr(state, {"tokens": toks}, w)
    res[f"{name}/params"] = state["params"].numpy()
    res[f"{name}/loss"] = np.float32(m["loss"])
    res[f"{name}/client_loss"] = m["client_loss"].numpy()
    res[f"{name}/block"] = np.array([rows.start, rows.stop, cols.start, cols.stop])
    made = rounds.make_state(cfg, f, opts[opt], device="cpu", mesh=mesh)
    for k, v in rounds.state_bytes(made).items():
        res[f"{name}/bytes/{k}"] = np.int64(v)
for name in inp["tree_shapes"].get((S, M), []):
    # the tree layout: the rank holds its clients' leaves, whole on every model rank
    cfg, f = cfgs["even"], fed(name, state_layout="tree")
    agg = rounds.make_aggregator(cfg, f, mesh)
    rows = packing.packed_pspec(C, "data", mesh)
    ts = inp["tree_state"]
    p, o = convert.tree_state_from_reference(ts["params"], ts["opt"], rows=rows)
    state = {"params": p, "opt": o, "round": 0,
             "agg": convert.agg_state_from_reference(inp["agg"][(name, "even")],
                                                     rows=rows if agg.row_state else None)}
    fr = rounds.build_fed_round(cfg, f, opts["sgd"], mesh)
    for _ in range(inp["rounds"]):
        state, m = fr(state, {"tokens": toks}, w)
    res[f"tree/{name}/params"] = rounds.tree_to_rows(agg.ctx.spec, state["params"], True).numpy()
    res[f"tree/{name}/loss"] = np.float32(m["loss"])
    res[f"tree/{name}/block"] = np.array([rows.start, rows.stop, 0, agg.ctx.spec.n_total])
if (S, M) == (1, 2):
    # the aggregation alone, on one (C, N) input and one state from another
    cfg = cfgs["even"]
    x0, x1 = (torch.from_numpy(a) for a in inp["agg_inputs"])
    mask = torch.tensor(inp["agg_mask"])
    for mode in inp["modes"]:
        agg = rounds.make_aggregator(cfg, fed(mode), mesh)
        rows, cols = packing.packed_block(C, agg.ctx.spec.n_total, "data", mesh)
        full = agg.init_state(x0)
        st = agg.state_block(full, rows, cols)
        blk, st = rounds.aggregate_sharded(agg, x1[rows, cols].clone(), mask * w / (mask * w).sum(),
                                           st, mask)
        res[f"agg/{mode}/packed"] = blk.numpy()
        for path, leaf in flatten_with_paths(st):
            res[f"agg/{mode}/state/{path}"] = np.asarray(leaf)
        if mode == "eq6":
            v = comp.contribution_scores(full["prev_sums"], st["prev_sums"])
            res["agg/eq6/upload"] = comp.topn_mask(v, 2).numpy()
    # the step's batch must split over the model axis
    res["err/batch"] = message(lambda: rounds.build_fed_round(cfg, fed("dense"), opts["sgd"], mesh)(
        rounds.make_state(cfg, fed("dense"), opts["sgd"], device="cpu", mesh=mesh),
        {"tokens": toks[:, :, :1]}, w))
    res["err/micro"] = message(lambda: rounds.build_fed_round(
        cfg, fed("dense", microbatches=3), opts["sgd"], mesh)(rounds.make_state(
            cfg, fed("dense"), opts["sgd"], device="cpu", mesh=mesh), {"tokens": toks}, w))
if (S, M) == (2, 1):
    cfg = cfgs["even"]
    own = packing.packed_pspec(C, "data", mesh)
    # core.fedavg's quant8: one scale per client shard, int8 blocks all-gathered
    from repro_torch.core import fedavg
    new, base = (map_tree(lambda x: torch.from_numpy(x[own]), t) for t in inp["fedavg_q8"])
    for path, leaf in flatten_with_paths(fedavg.aggregate_quant8(new, base, w, mesh, "data")):
        res[f"fedavg_q8/{path}"] = leaf.numpy()
    # fedsgd: the client axis as data-parallel ranks of one shared copy
    st = inp["fedsgd_state"]
    row, o = convert.fedsgd_state_from_reference(cfg, st["params"], st["opt"])
    fr = rounds.build_fed_round(cfg, fed("fedsgd"), opts["sgd"], mesh)
    state = {"params": row, "opt": o, "agg": {}, "round": 0}
    for _ in range(inp["rounds"]):
        state, m = fr(state, {"tokens": torch.from_numpy(inp["merged"])}, w)
    res["fedsgd/params"], res["fedsgd/loss"] = state["params"].numpy(), np.float32(m["loss"])
    res["fedsgd/client_loss"] = m["client_loss"].numpy()
    # the buffered and streaming engines
    for kind, (mode, kw) in inp["engines"].items():
        lm = explorer.ClientLoadModel(C, seed=0)
        lm.baseline = np.array(inp["baseline"], float)
        lm.loads = lm.baseline.copy()
        cls = ae.StreamingAsyncEngine if kind == "streaming" else ae.BufferedAsyncEngine
        eng = cls(cfg, fed(mode, **inp["engine"], **kw), opts["stream" if kind == "streaming" else "sgd"],
                  seed=0, load_model=lm, timing=ae.TimingModel(**inp["timing"]), device="cpu",
                  mesh=mesh)
        js = inp["engine_states"][kind]
        if kind == "streaming":
            eng.set_state({**eng.state, "ring": torch.tensor(js["ring"])})
        else:
            p, o = convert.state_from_reference(cfg, js["params"], js["opt"], rows=own)
            eng.set_state({"params": p, "opt": o, "round": 0,
                           "agg": convert.agg_state_from_reference(js["agg"], rows=own)})
        for i in range(inp["flushes"]):
            rec = eng.step_round({"tokens": inp["engine_toks"][i]})
            for key in ("participants", "staleness", "dropped", "sim_time", "weights", "loss"):
                res[f"{kind}/{i}/{key}"] = np.asarray(getattr(rec, key))
        res[f"{kind}/global"] = eng.global_packed_row().numpy()
np.savez(f"{out}/{S}x{M}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def inputs():
    """The initial states every run starts from (the port's first dispatch
    in every row, zero moments, the reference's aggregator state of it),
    the tokens and the cases, as the rank processes read them."""
    states, agg = {}, {}
    for cfg_name, (jcfg, tcfg) in CFGS.items():
        row = rounds.initial_row(rounds.make_aggregator(tcfg, _fed("torch", "dense")),
                                 device="cpu")
        packed = row.expand(C, -1).contiguous()
        zero = torch.zeros_like(packed)
        for opt, moments in (("sgd", {"mu": zero}),
                             ("adamw", {"m": zero, "v": zero, "t": torch.zeros(C, dtype=torch.int32)})):
            params, tree = convert.state_to_reference(tcfg, packed, moments)
            states[(opt, cfg_name)] = {"params": params, "opt": tree}
        for mode in MODES:
            jagg = JR.make_aggregator(jcfg, _fed("jax", mode))
            agg[(mode, cfg_name)] = _np(jagg.init_state(jnp.asarray(states[("sgd", cfg_name)]["params"])))
    states[("sgd-clip", "even")] = states[("sgd", "even")]
    params = states[("sgd", "even")]["params"]
    tpl = rounds.make_template(CFGS["even"][1])
    spec = packing.build_pack_spec(CFGS["even"][1], tpl)
    # fedsgd's one shared copy: the dispatch's tree, and zero momentum
    shared = convert.lm_params_to_reference(map_tree(lambda x: x[0], packing.unpack(
        spec, torch.from_numpy(params[:1]), tpl)))
    engine_states = {"buffered": {"params": params, "opt": states[("sgd", "even")]["opt"],
                                  "agg": agg[("eq6", "even")]},
                     "streaming": {"ring": np.repeat(params[:1], ENGINES["streaming"][1]["max_staleness"]
                                                     + 1, axis=0)}}
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=params.shape).astype(np.float32)
    # the sgd state as the reference's tree layout holds it
    tree_params, _ = convert.tree_state_to_reference(packing.unpack(spec, torch.from_numpy(params), tpl), {})
    tree_state = {"params": tree_params, "opt": states[("sgd", "even")]["opt"]}
    noisy = map_tree(lambda x: (x + 0.01 * rng.normal(size=x.shape)).astype(np.float32), tree_params)
    return {"C": C, "rounds": ROUNDS, "flushes": FLUSHES, "weights": WEIGHTS, "modes": MODES,
            "cases": CASES, "shapes": SHAPES, "cfgs": NARROW, "tree_shapes": TREE_SHAPES,
            "tree_state": tree_state, "fedavg_q8": (noisy, tree_params),
            "states": states, "agg": agg, "toks": _toks(1), "merged": _merged(_toks(1)),
            "fedsgd_state": {"params": shared, "opt": {"mu": jax.tree.map(np.zeros_like, shared)}},
            "engine": ENGINE, "engines": ENGINES, "engine_states": engine_states,
            "timing": TIMING, "engine_toks": [_toks(10 + i) for i in range(FLUSHES)],
            "baseline": BASELINE, "agg_mask": [1.0, 0.0, 1.0, 1.0],
            "agg_inputs": (x0, x0 + np.float32(0.01) * rng.normal(size=x0.shape).astype(np.float32))}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    """Starts every mesh shape's ranks (2 + 2 + 4 processes of 1 thread) and
    returns at once: the reference's programs compile while they run."""
    out = tmp_path_factory.mktemp("sharded")
    (out / "worker.py").write_text(_WORKER)
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                                        os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    procs = {}
    for S, M in SHAPES:
        (out / f"{S}x{M}").mkdir()
        procs[(S, M)] = [subprocess.Popen(
            [sys.executable, str(out / "worker.py"), str(S), str(M), str(r), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(S * M)]
    yield out, procs
    for ps in procs.values():
        for p in ps:
            p.kill()


@pytest.fixture(scope="module")
def baselines(inputs):
    """The reference's meshless runs of every case (``microbatches`` 2, the
    parts the meshes' 2 ranks take), fedsgd (2) and the engines (1), from
    the same states, and the port's (:func:`meshless_runs`); four at a
    time, so that the reference's programs compile side by side."""
    from concurrent.futures import ThreadPoolExecutor

    jopts = _opts(joptim)
    toks, w = jnp.asarray(inputs["toks"]), jnp.asarray(WEIGHTS)

    def case(name):
        mode, opt, cfg_name, _ = CASES[name]
        st = inputs["states"][(opt, cfg_name)]
        state = {"params": jnp.asarray(st["params"]), "opt": jax.tree.map(jnp.asarray, st["opt"]),
                 "agg": jax.tree.map(jnp.asarray, inputs["agg"][(mode, cfg_name)]),
                 "round": jnp.int32(0)}
        fr = jax.jit(JR.build_fed_round(CFGS[cfg_name][0], _fed("jax", mode, microbatches=2),
                                        jopts[opt]))
        for _ in range(ROUNDS):
            state, m = fr(state, {"tokens": toks}, w)
        return np.asarray(state["params"]), float(m["loss"])

    def fedsgd():
        st = inputs["fedsgd_state"]
        state = {"params": st["params"], "opt": st["opt"], "agg": {}, "round": jnp.int32(0)}
        fr = jax.jit(JR.build_fed_round(CFGS["even"][0], _fed("jax", "fedsgd", microbatches=2),
                                        jopts["sgd"]))
        for _ in range(ROUNDS):
            state, m = fr(state, {"tokens": jnp.asarray(inputs["merged"])}, w)
        return (convert.fedsgd_state_from_reference(CFGS["even"][1], _np(state["params"]),
                                                    {})[0].numpy(), float(m["loss"]))

    def engine(kind):
        mode, kw = ENGINES[kind]
        cls = jae.StreamingAsyncEngine if kind == "streaming" else jae.BufferedAsyncEngine
        eng = cls(CFGS["even"][0], _fed("jax", mode, **ENGINE, **kw),
                  jopts["stream" if kind == "streaming" else "sgd"], seed=0,
                  load_model=_load_model(jexplorer), timing=jae.TimingModel(**TIMING))
        st = jax.tree.map(jnp.asarray, inputs["engine_states"][kind])
        eng.state = {**eng.state, **st}
        recs = [eng.step_round({"tokens": jnp.asarray(inputs["engine_toks"][i])})
                for i in range(FLUSHES)]
        return recs, np.asarray(eng.global_packed_row())

    jobs = {**{name: (case, name) for name in CASES}, "fedsgd": (fedsgd,),
            **{kind: (engine, kind) for kind in ENGINES}}
    with ThreadPoolExecutor(4) as pool:
        port = pool.submit(meshless_runs, inputs)
        futures = {k: pool.submit(*job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}, port.result()


@pytest.fixture(scope="module")
def reference(baselines):
    return baselines[0]


@pytest.fixture(scope="module")
def meshless(baselines):
    return baselines[1]


@pytest.fixture(scope="module")
def ranks(spawned, baselines):
    """Waits for every rank (a hard 240 s limit) -> {(S, M): [rank dicts]}."""
    out, procs = spawned
    res = {}
    for shape, ps in procs.items():
        logs = [p.communicate(timeout=240)[0] for p in ps]
        for p, log in zip(ps, logs):
            assert p.returncode == 0, log
        res[shape] = [dict(np.load(out / f"{shape[0]}x{shape[1]}" / f"rank{r}.npz"))
                      for r in range(len(ps))]
    return res


def meshless_runs(inputs):
    """The port's meshless runs from the same carried states: each case at
    ``microbatches`` 2, the twin of its sharded arithmetic on the meshes'
    2 model ranks, fedsgd at 2 (the (2, 1) mesh's client ranks), the
    engines (no batch split), and each case's state bytes."""
    opts = _opts(toptim)
    toks = torch.from_numpy(inputs["toks"])
    res = {}
    for name, (mode, opt, cfg_name, kw) in CASES.items():
        cfg, st = CFGS[cfg_name][1], inputs["states"][(opt, cfg_name)]
        p, o = convert.state_from_reference(cfg, st["params"], st["opt"])
        state = {"params": p, "opt": o, "round": 0,
                 "agg": convert.agg_state_from_reference(inputs["agg"][(mode, cfg_name)])}
        fed = _fed("torch", mode, microbatches=2, **kw)
        fr = rounds.build_fed_round(cfg, fed, opts[opt])
        for _ in range(ROUNDS):
            state, m = fr(state, {"tokens": toks}, torch.tensor(WEIGHTS))
        made = rounds.make_state(cfg, fed, opts[opt], device="cpu")
        res[name] = (state["params"].numpy(), float(m["loss"]), m["client_loss"].numpy(),
                     rounds.state_bytes(made))
    ts = inputs["tree_state"]
    for micro, names in ((2, TREE_SHAPES[(1, 2)]), (1, TREE_SHAPES[(2, 1)])):
        for name in names:  # the tree twins: the (1, 2) mesh's 2 parts, the (2, 1) mesh's one
            p, o = convert.tree_state_from_reference(ts["params"], ts["opt"])
            state = {"params": p, "opt": o, "round": 0,
                     "agg": convert.agg_state_from_reference(inputs["agg"][(name, "even")])}
            fed = _fed("torch", name, microbatches=micro, state_layout="tree")
            fr = rounds.build_fed_round(CFGS["even"][1], fed, opts["sgd"])
            for _ in range(ROUNDS):
                state, m = fr(state, {"tokens": toks}, torch.tensor(WEIGHTS))
            spec = rounds.make_aggregator(CFGS["even"][1], fed).ctx.spec
            res[("tree", micro, name)] = (rounds.tree_to_rows(spec, state["params"], True).numpy(),
                                          float(m["loss"]))
    st = inputs["fedsgd_state"]
    row, o = convert.fedsgd_state_from_reference(CFGS["even"][1], st["params"], st["opt"])
    state = {"params": row, "opt": o, "agg": {}, "round": 0}
    fr = rounds.build_fed_round(CFGS["even"][1], _fed("torch", "fedsgd", microbatches=2),
                                opts["sgd"])
    for _ in range(ROUNDS):
        state, m = fr(state, {"tokens": torch.from_numpy(inputs["merged"])}, torch.tensor(WEIGHTS))
    res["fedsgd"] = (state["params"].numpy(), float(m["loss"]), m["client_loss"].numpy())
    for kind, (mode, kw) in ENGINES.items():
        cls = ae.StreamingAsyncEngine if kind == "streaming" else ae.BufferedAsyncEngine
        eng = cls(CFGS["even"][1], _fed("torch", mode, **ENGINE, **kw),
                  opts["stream" if kind == "streaming" else "sgd"], seed=0,
                  load_model=_load_model(explorer), timing=ae.TimingModel(**TIMING),
                  device="cpu")
        js = inputs["engine_states"][kind]
        if kind == "streaming":
            eng.set_state({**eng.state, "ring": torch.tensor(js["ring"])})
        else:
            p, o = convert.state_from_reference(CFGS["even"][1], js["params"], js["opt"])
            eng.set_state({"params": p, "opt": o, "round": 0,
                           "agg": convert.agg_state_from_reference(js["agg"])})
        res[kind] = ([eng.step_round({"tokens": inputs["engine_toks"][i]}) for i in range(FLUSHES)],
                     eng.global_packed_row().numpy())
    return res


def _assembled(rs, key, S, M):
    """The whole (C, N) buffer from every rank's block of it."""
    C_, N = None, None
    blocks = [(r[f"{key}/block"], r[f"{key}/params"]) for r in rs]
    C_, N = max(b[1] for b, _ in blocks), max(b[3] for b, _ in blocks)
    out = np.full((C_, N), np.nan, np.float32)
    for (r0, r1, c0, c1), p in blocks:
        if not np.isnan(out[r0:r1, c0:c1]).all():  # a whole flat dim: every model rank alike
            np.testing.assert_array_equal(out[r0:r1, c0:c1].view(np.int32), p.view(np.int32))
        out[r0:r1, c0:c1] = p
    assert not np.isnan(out).any()
    return out


def _gap(a, b):
    return float(np.max(np.abs(a.astype(np.float64) - b)) / max(np.max(np.abs(b)), 1e-9))


def _hold_reference(name, got, loss, want, want_loss):
    """Loss rtol 1e-5; params rtol 1e-4 / atol 1e-5 (``tests/test_torch_lm_train_rounds.py``'s
    rounds). Under a rounding or selection mode or adamw, the packages'
    local training differs by about 1e-7 relative, which flips a rounding,
    a top-k choice or the sign of adamw's step at a near-zero gradient: at
    most 1e-4 of the elements may then be off that bound (the rule of
    ``tests/test_torch_participation.py``'s quant8 rounds; printed, at most
    2.6e-5 measured, quant4's), by at most one step: a weighted quant4 step
    (1e-3) or adamw's 2 lr a round."""
    mode, opt = CASES[name][:2]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-5)
    print(f"{name}: {int(off.sum())} elements ({off.mean():.2e}) off the reference's bound")
    flips = mode in ("quant8", "quant4", "secure", "topk_ef") or opt == "adamw"
    assert off.sum() <= (1e-4 * got.size if flips else 0), (name, int(off.sum()))
    step = 2 * 3e-3 * ROUNDS if opt == "adamw" else 1e-3
    np.testing.assert_allclose(got[off], want[off], rtol=0, atol=step, err_msg=name)


@pytest.mark.parametrize("shape,name", [(s, n) for s, names in SHAPES.items() for n in names])
def test_sharded_round_matches_meshless_and_reference(shape, name, ranks, meshless, reference):
    S, M = shape
    mode = CASES[name][0]
    rs = ranks[shape]
    got = _assembled(rs, name, S, M)
    want, loss, client_loss, _ = meshless[name]
    gap = _gap(got, want)
    print(f"{name} on {S} x {M}: relative max gap {gap:.3e} against the meshless twin, "
          f"{_gap(got, reference[name][0]):.3e} against the reference")
    assert gap < 1e-6
    for r in rs:  # every rank reports the whole cohort's metrics
        assert abs(float(r[f"{name}/loss"]) - loss) < 1e-6
        np.testing.assert_allclose(r[f"{name}/client_loss"], client_loss, rtol=0, atol=1e-6)
    _hold_reference(name, got, float(rs[0][f"{name}/loss"]), *reference[name])


@pytest.mark.parametrize("shape,name", [(s, n) for s, names in SHAPES.items() for n in names])
def test_each_rank_holds_its_share_of_the_state(shape, name, ranks, meshless):
    """make_state on the mesh: no byte of a flat buffer held twice."""
    S, M = shape
    want = meshless[name][3]
    m = 1 if CASES[name][2] == "odd" else M  # an odd N_total keeps its flat dim whole
    for r in ranks[shape]:
        got = {k: int(r[f"{name}/bytes/{k}"]) for k in ("clients", "server", "other")}
        assert got["clients"] * S * m == want["clients"], (got, want)
        assert got["server"] * m == want["server"], (got, want)
        assert got["other"] == want["other"], (got, want)
        assert got["clients"] > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_aggregation_alone_on_blocks(mode, ranks, inputs):
    """aggregate_sharded on the (1, 2) mesh against the meshless aggregate
    on one input: bitwise (eq6, and hier over it: the same choices, values
    within 1e-6)."""
    agg = rounds.make_aggregator(CFGS["even"][1], _fed("torch", mode))
    x0, x1 = (torch.from_numpy(a) for a in inputs["agg_inputs"])
    mask = torch.tensor(inputs["agg_mask"])
    w = mask * torch.tensor(WEIGHTS)
    full = agg.init_state(x0)
    out, st = agg.aggregate(x1.clone(), w / w.sum(), full, mask)
    n = out.shape[1]
    rs = ranks[(1, 2)]
    got = np.concatenate([r[f"agg/{mode}/packed"] for r in rs], axis=1)
    sums = mode in ("eq6", "hier")  # layer sums added from the blocks' parts
    if sums:
        assert _gap(got, out.numpy()) < 1e-6
    if mode == "eq6":
        want_up = comp.topn_mask(comp.contribution_scores(full["prev_sums"], st["prev_sums"]), 2)
        for r in rs:
            np.testing.assert_array_equal(r["agg/eq6/upload"], want_up.numpy())
    if not sums:
        np.testing.assert_array_equal(got.view(np.int32), out.numpy().view(np.int32))
    for j, r in enumerate(rs):
        blk = agg.state_block(st, slice(0, C), slice(j * n // 2, (j + 1) * n // 2))
        for path, leaf in flatten_with_paths(blk):
            mine = r[f"agg/{mode}/state/{path}"]
            if sums:
                assert _gap(mine, np.asarray(leaf)) < 1e-6, path
            else:
                np.testing.assert_array_equal(mine, np.asarray(leaf), err_msg=path)


def test_fedsgd_over_a_sharded_client_axis(ranks, meshless, reference):
    """(2, 1): the client axis's ranks train one shared copy, each on its
    clients' part of the merged batch."""
    want, loss, client_loss = meshless["fedsgd"]
    for r in ranks[(2, 1)]:
        gap = _gap(r["fedsgd/params"], want)
        print(f"fedsgd on 2 x 1: relative max gap {gap:.3e}")
        assert gap < 1e-6 and abs(float(r["fedsgd/loss"]) - loss) < 1e-6
        np.testing.assert_array_equal(r["fedsgd/client_loss"], client_loss)
        np.testing.assert_allclose(r["fedsgd/params"], reference["fedsgd"][0], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(r["fedsgd/loss"]), reference["fedsgd"][1], rtol=1e-5)


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_engine_over_a_sharded_client_axis(kind, ranks, meshless, reference):
    """(2, 1): every rank's records are the meshless engine's; the global
    within 1e-6 of it and at the reference's bounds of the reference's."""
    recs, g = meshless[kind]
    jrecs, jg = reference[kind]
    assert max(max(rec.staleness) for rec in recs) >= 1  # stale updates landed
    assert kind == "streaming" or sum(rec.dropped for rec in recs) >= 1  # and one was dropped
    for r in ranks[(2, 1)]:
        for i, (rec, jrec) in enumerate(zip(recs, jrecs)):
            for key in ("participants", "staleness", "dropped", "sim_time", "weights"):
                assert np.asarray(getattr(rec, key)).tolist() == r[f"{kind}/{i}/{key}"].tolist()
                assert np.asarray(getattr(jrec, key)).tolist() == r[f"{kind}/{i}/{key}"].tolist()
            assert float(r[f"{kind}/{i}/loss"]) == rec.loss
            np.testing.assert_allclose(float(r[f"{kind}/{i}/loss"]), jrec.loss, rtol=1e-5)
        gap = _gap(r[f"{kind}/global"], g)
        print(f"{kind} engine on 2 x 1: relative max gap {gap:.3e}")
        assert gap < 1e-6
        np.testing.assert_allclose(r[f"{kind}/global"], jg, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape,name", [(s, n) for s, names in TREE_SHAPES.items() for n in names])
def test_tree_round_on_a_mesh_matches_its_meshless_twin(shape, name, ranks, meshless):
    """The tree layout on (1, 2) (leaves whole on both model ranks, the
    step's batch split) and on (2, 1) (each rank its 2 clients' leaves)
    against the port's meshless tree round of the same split."""
    S, M = shape
    rs = ranks[shape]
    got = _assembled(rs, f"tree/{name}", S, M)  # model ranks hold the same bits
    want, loss = meshless[("tree", 2 if M == 2 else 1, name)]
    gap = _gap(got, want)
    print(f"tree {name} on {S} x {M}: relative max gap {gap:.3e} against the meshless twin")
    assert gap < 1e-6
    for r in rs:
        assert abs(float(r[f"tree/{name}/loss"]) - loss) < 1e-6


def test_fedavg_quant8_on_two_client_shards(ranks, inputs):
    """``core.fedavg.aggregate_quant8`` on the (2, 1) mesh: each rank's rows
    of base + the weighted mean of the deltas, each shard's rows dequantized
    by the scale of that shard's block (the plain formula, in NumPy here:
    the same IEEE steps to the int8 values, the mean within 1e-6)."""
    new, base = inputs["fedavg_q8"]
    w, k = np.asarray(WEIGHTS, np.float32), C // 2
    for (path, n), (_, b) in zip(flatten_with_paths(new), flatten_with_paths(base)):
        delta = n - b
        d = np.empty_like(delta)
        for sh in range(2):
            blk = delta[sh * k: (sh + 1) * k]
            scale = np.maximum(np.abs(blk).max(), np.float32(1e-12)) / np.float32(127.0)
            d[sh * k: (sh + 1) * k] = np.clip(np.round(blk / scale), -127, 127) * scale
        gd = np.tensordot(w, d, axes=1)
        for r, rank in enumerate(ranks[(2, 1)]):
            np.testing.assert_allclose(rank[f"fedavg_q8/{path}"], b[r * k: (r + 1) * k] + gd[None],
                                       rtol=1e-6, atol=1e-7, err_msg=path)


@pytest.mark.parametrize("key,match", [
    ("err/batch", "ValueError: a local batch of 1 does not split over the 2 data-parallel ranks"),
    ("err/micro", "ValueError: a local batch of 2 in 3 microbatches does not split over the 2 "
                  "data-parallel ranks"),
])
def test_the_step_must_split_over_the_model_axis(key, match, ranks):
    for r in ranks[(1, 2)]:
        assert re.match(match, str(r[key])), str(r[key])


def test_block_runs_tile_the_flat_dim():
    """The bucket ids, expansions and sums of blocks (any cut, buckets cut
    at the edges) are the whole row's, cut."""
    cfg = CFGS["even"][1]
    spec = packing.build_pack_spec(cfg, rounds.make_template(cfg))
    n = spec.n_total
    ids = torch.from_numpy(packing.bucket_ids(spec))
    vec = torch.arange(spec.n_buckets, dtype=torch.float32)[None] + 1.0
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, n)).astype(np.float32))
    whole = packing.bucket_sums(spec, x)
    for cuts in ([0, n // 2, n], [0, 1, 12345, n // 3 + 7, n - 1, n]):
        sums = torch.zeros_like(whole)
        for a, b in zip(cuts[:-1], cuts[1:]):
            cols = slice(a, b)
            assert torch.equal(packing.bucket_ids_on(spec, torch.device("cpu"), cols), ids[a:b])
            assert torch.equal(packing.expand_bucket_vec(spec, vec, cols),
                               packing.expand_bucket_vec(spec, vec)[:, a:b])
            sums += packing.bucket_sums(spec, x[:, a:b], cols)
        torch.testing.assert_close(sums, whole, rtol=1e-5, atol=1e-3)

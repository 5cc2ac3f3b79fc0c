"""The layer-by-layer gather of a model-sharded local step
(``repro_torch.core.layer_gather``, ``rounds.local_training`` where the
``"model"`` axis splits the flat dim, ``transformer.trunk`` over a gather)
on 2- and 4-rank gloo groups, held against the port's meshless runs.

The ranks run as processes of one thread over a ``FileStore`` rendezvous
(no port), with a hard limit, while this process runs the meshless twins.
The models are tiny configs of six LM families at d_model 128, d_ff 256
and a vocabulary of 256 (qwen3-1.7b's dense stack, mamba2-1.3b's ssm
stack, gemma3-27b with a period of 3 over 5 layers: one period group and a
tail of 2, zamba2-2.7b's two Mamba2 groups of 2 with the shared block,
granite-moe-1b-a400m's 4 experts, hubert-xlarge's encoder, whose unused
embedding takes a zero gradient and whose loss reads only the masked
frames; 4 layers where the family allows) and the reduced fedyolov3, which
has no stack: its one unit is the whole row. Each
N_total is even, so the 2 model ranks split the flat dim. Every run starts
from the seed's initial state; sgd lr 0.05 (its default clip at 10, whose
norm sums the blocks' parts), C = 2 clients, one round of one local step.

Tolerances, each stated where it is used:

- against the port's meshless twin (``microbatches`` = P, the parts the P
  ranks take): relative max gap below 1e-6 and losses within 1e-6, the
  bounds of ``tests/test_torch_sharded.py``. With ``microbatches`` 4 on 2
  ranks (m > P) a rank's two parts are reduced one by one, so the sums come
  in another order than the twin's: the same bounds hold;
- the gather's high-water on every rank: at most 2 x (rest unit + the
  largest layer unit) bytes, and below one row's bytes;
- the collectives of one local step: calls and bytes equal to the plan's
  arithmetic, exactly.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import layer_gather, packing, rounds
from repro_torch.data.pipeline import fed_batches
from repro_torch.optim import sgd

ROOT = Path(__file__).resolve().parents[1]
C, LR, SEQ, IMG = 2, 0.05, 16, 32
TINY = dict(d_model=128, d_ff=256, vocab_size=256)
# family -> (arch, overrides of its reduced config)
FAMILIES = {"dense": ("qwen3-1.7b", dict(TINY, n_layers=4)),
            "ssm": ("mamba2-1.3b", dict(TINY, n_layers=4)),
            "gemma3": ("gemma3-27b", dict(TINY, n_layers=5, local_global_period=3)),
            "hybrid": ("zamba2-2.7b", dict(TINY, n_layers=4)),
            "moe": ("granite-moe-1b-a400m", dict(TINY, n_layers=4)),
            "audio": ("hubert-xlarge", dict(TINY, n_layers=4)),
            "yolo": ("fedyolov3", {})}
# case -> (family, mesh shape, aggregation, microbatches)
CASES = {**{f: (f, (1, 2), "dense", 1) for f in FAMILIES},
         "dense-micro4": ("dense", (1, 2), "dense", 4),
         "dense-fedsgd": ("dense", (2, 2), "fedsgd", 1)}
SHAPES = sorted({c[1] for c in CASES.values()})


def config(family):
    arch, kw = FAMILIES[family]
    return dataclasses.replace(get_arch(arch).reduced(), **kw)


def fed_of(aggregation, microbatches=1):
    return rounds.FedConfig(n_clients=C, local_steps=1, aggregation=aggregation,
                            client_axis="data", data_axis=None, microbatches=microbatches)


def batch_of(family):
    """The round's batch (C, 1, b, ...): b 4 for an LM, 2 images."""
    cfg = config(family)
    if family == "yolo":
        return next(fed_batches(cfg, fed_of("dense"), batch=2, seq=0, img_size=IMG))
    if family == "audio":
        return next(fed_batches(cfg, fed_of("dense"), batch=4, seq=SEQ))
    return {"tokens": np.random.default_rng(1).integers(0, 256, (C, 1, 4, SEQ)).astype(np.int32)}


def plan_of(family, M=2):
    cfg = config(family)
    tpl = rounds.make_template(cfg)
    return layer_gather.build_plan(packing.build_pack_spec(cfg, tpl), tpl, M)


# one rank: every case of its mesh shape -> <out>/<S>x<M>/rank<r>.pkl
_WORKER = r"""
import dataclasses, datetime, gc, pickle, sys
import numpy as np, torch, torch.distributed as dist
S, M, rank, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(f"{out}/store{S}x{M}", S * M), rank=rank,
                        world_size=S * M, timeout=datetime.timedelta(seconds=120))
sys.path.insert(0, sys.argv[5])
import test_torch_sharded_gather as T
torch.set_num_threads(1)
gc.disable()  # the bounds hold without the collector: no gathered unit sits in a cycle
from repro_torch.core import collectives, layer_gather, rounds
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.params import map_tree
from repro_torch.optim import sgd

mesh = make_host_mesh(S, M, "cpu")
res = {}
for name, (family, shape, aggregation, micro) in T.CASES.items():
    if shape != (S, M):
        continue
    cfg, fed, opt = T.config(family), T.fed_of(aggregation, micro), sgd(T.LR)
    batch = rounds.to_device(T.batch_of(family), "cpu")
    if aggregation == "fedsgd":
        batch = rounds.merge_clients(batch)
    state = rounds.make_state(cfg, fed, opt, rounds.seed_generator(cfg, 0, "cpu"), "cpu", mesh=mesh)
    fr = rounds.build_fed_round(cfg, fed, opt, mesh)
    layer_gather.reset_stats()
    state, m = fr(state, batch, rounds.uniform_weights(T.C))
    r = {"params": collectives.all_gather(state["params"], mesh, "model", axis=-1).numpy(),
         "loss": float(m["loss"]), "client_loss": m["client_loss"].numpy(),
         "high": layer_gather.stats["high"], "live": layer_gather.stats["live"]}
    # one local step alone: its collectives and gathers
    state = rounds.make_state(cfg, fed, opt, rounds.seed_generator(cfg, 0, "cpu"), "cpu", mesh=mesh)
    train = rounds.local_training(cfg, fed, opt, mesh, shared=aggregation == "fedsgd")
    if aggregation == "fedsgd":
        row, opt_row, step = state["params"], state["opt"], batch
    else:
        row, opt_row = state["params"][0], {k: v[0] for k, v in state["opt"].items()}
        step = map_tree(lambda x: x[0], batch)
    layer_gather.reset_stats()
    collectives.reset_stats()
    train(row, opt_row, step)
    r.update(calls=collectives.stats["calls"], bytes=collectives.stats["bytes"],
             units=layer_gather.stats["units"], unit_bytes=layer_gather.stats["bytes"])
    res[name] = r
with open(f"{out}/{S}x{M}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Starts every mesh shape's ranks (2 + 4 processes of one thread) and
    returns at once: the meshless twins run while they do."""
    out = tmp_path_factory.mktemp("gather")
    (out / "worker.py").write_text(_WORKER)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    procs = {}
    for S, M in SHAPES:
        (out / f"{S}x{M}").mkdir()
        procs[(S, M)] = [subprocess.Popen(
            [sys.executable, str(out / "worker.py"), str(S), str(M), str(r), str(out),
             str(ROOT / "tests")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(S * M)]
    yield out, procs
    for ps in procs.values():
        for p in ps:
            p.kill()


@pytest.fixture(scope="module")
def meshless(spawned):
    """The port's meshless twin of each case: ``microbatches`` = P (or the
    case's own), from the same seed's state."""
    res = {}
    for name, (family, (S, M), aggregation, micro) in CASES.items():
        P = M * (S if aggregation == "fedsgd" else 1)
        cfg, fed, opt = config(family), fed_of(aggregation, max(micro, P)), sgd(LR)
        batch = rounds.to_device(batch_of(family), "cpu")
        if aggregation == "fedsgd":
            batch = rounds.merge_clients(batch)
        state = rounds.make_state(cfg, fed, opt, rounds.seed_generator(cfg, 0, "cpu"), "cpu")
        state, m = rounds.build_fed_round(cfg, fed, opt)(state, batch, rounds.uniform_weights(C))
        res[name] = (state["params"].numpy(), float(m["loss"]), m["client_loss"].numpy())
    return res


@pytest.fixture(scope="module")
def ranks(spawned, meshless):
    """Waits for every rank (a hard 120 s limit) -> {(S, M): [rank dicts]}."""
    out, procs = spawned
    res = {}
    for (S, M), ps in procs.items():
        logs = [p.communicate(timeout=120)[0] for p in ps]
        for p, log in zip(ps, logs):
            assert p.returncode == 0, log
        res[(S, M)] = []
        for r in range(S * M):
            with open(out / f"{S}x{M}" / f"rank{r}.pkl", "rb") as f:
                res[(S, M)].append(pickle.load(f))
    return res


def _gap(a, b):
    return float(np.max(np.abs(a.astype(np.float64) - b)) / max(np.max(np.abs(b)), 1e-9))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gathered_round_matches_meshless_twin(name, ranks, meshless):
    family, shape, _, _ = CASES[name]
    want, loss, client_loss = meshless[name]
    for r in ranks[shape]:
        got = r[name]
        gap = _gap(got["params"], want)
        print(f"{name} on {shape[0]} x {shape[1]}: relative max gap {gap:.3e} against the "
              f"meshless twin, loss {got['loss']!r} against {loss!r}")
        assert gap < 1e-6
        assert abs(got["loss"] - loss) < 1e-6
        np.testing.assert_allclose(got["client_loss"], client_loss, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_high_water_is_one_layer_not_the_row(name, ranks):
    """No rank holds a whole row or gradient: the gather's buffers peak at
    2 x (rest + largest layer) at most, below the row's bytes, and are all
    freed after the round."""
    family, shape, _, _ = CASES[name]
    plan = plan_of(family)
    largest = max((u.size for u in plan.layers.values()), default=0)
    bound, row = 2 * (plan.rest.size + largest) * 4, plan.n_total * 4
    for j, r in enumerate(ranks[shape]):
        high = r[name]["high"]
        print(f"{name} rank {j}: high-water {high} B, bound {bound} B (rest {plan.rest.size * 4} B, "
              f"largest layer {largest * 4} B), row {row} B")
        assert 0 < high <= bound and (high < row or not plan.layers)
        assert r[name]["live"] == 0


def passes(family, key) -> int:
    """Gathers of a unit in one pass: the rest unit once; a layer in the
    forward and in its checkpoint's recompute; a layer of a gemma3 or zamba2
    group once more, in the group's recompute, except the last of a gemma3
    group, after whose input the group's recompute stops (torch's
    checkpoint stops once it has every tensor the backward needs)."""
    if not key:
        return 1
    if key[0] not in ("groups", "mamba_groups"):
        return 2
    last = key[2] == config(family).local_global_period - 1
    return 2 if key[0] == "groups" and last else 3


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_collectives_equal_the_plan(name, ranks):
    """One local step: a broadcast per owner of each gathered unit, a
    reduce per owner of each unit's gradient, the loss's and the clip's
    all-reduces (and with fedsgd over 2 client ranks, the loss's and the
    block gradient's over the client axis); 4 bytes a scalar."""
    family, (S, M), aggregation, micro = CASES[name]
    plan = plan_of(family)
    P = M * (S if aggregation == "fedsgd" else 1)
    parts = (micro if micro > 1 else P) // P  # the passes a rank runs
    units = parts * sum(passes(family, u.key) for u in plan.units())
    unit_bytes = parts * sum(passes(family, u.key) * u.size * 4 for u in plan.units())
    calls = parts * sum((passes(family, u.key) + 1) * len(u.segments) for u in plan.units()) + 2
    nbytes = unit_bytes + parts * sum(u.size * 4 for u in plan.units()) + 8
    if S > 1:  # fedsgd's client ranks: the loss and the block gradient
        calls, nbytes = calls + 2, nbytes + 4 + plan.block * 4
    for j, r in enumerate(ranks[(S, M)]):
        got = r[name]
        print(f"{name} rank {j}: {got['units']} units {got['unit_bytes']} B gathered, "
              f"{got['calls']} collective calls {got['bytes']} B a step")
        assert (got["units"], got["unit_bytes"]) == (units, unit_bytes)
        assert (got["calls"], got["bytes"]) == (calls, nbytes)


def test_fedyolov3_gathers_one_unit_a_step(ranks):
    """fedyolov3 has no stack: its step gathers its one unit, the whole
    row, once, the bytes the whole-row all-gather filled."""
    plan = plan_of("yolo")
    assert not plan.layers and plan.rest.size == plan.n_total
    for r in ranks[(1, 2)]:
        assert (r["yolo"]["units"], r["yolo"]["unit_bytes"]) == (1, plan.n_total * 4)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("M", [2, 4])
def test_plan_tiles_the_row(family, M):
    """The units' pieces cover each element of the row once; each segment
    lies in its owner's block, one segment per owner a unit, in rank order;
    each unit's leaves fill its buffer, shaped like the template's entries."""
    cfg = config(family)
    tpl = rounds.make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    if spec.n_total % M:
        pytest.skip(f"{M} ranks do not divide N_total {spec.n_total}: the flat dim stays whole")
    plan = layer_gather.build_plan(spec, tpl, M)
    seen = np.zeros(spec.n_total, np.int32)
    for u in plan.units():
        owners = [s.owner for s in u.segments]
        assert owners == sorted(set(owners))
        assert u.size == sum(max(math.prod(s), 1) for _, s in u.leaves)
        pos = 0
        for s in u.segments:
            assert s.lo == pos
            for off, n in s.pieces:
                assert s.owner * plan.block <= off and off + n <= (s.owner + 1) * plan.block
                seen[off: off + n] += 1
                pos += n
            assert s.hi == pos
        assert pos == u.size
    assert (seen == 1).all()
    n_layers = sum(math.prod(c) for c in plan.counts.values())
    assert len(plan.layers) == n_layers
    assert cfg.family == "yolo" or n_layers == cfg.n_layers

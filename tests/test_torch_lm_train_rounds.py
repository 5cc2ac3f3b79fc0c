"""The port's LM rounds (the eq6 round at the compression demo's settings
under sgd and adamw, microbatches, the demo's report and ``fedavg_tree`` on
its state) held against the reference on the CPU, with
``tests/test_torch_lm_train.py``'s configs: the reduced qwen3-1.7b and
mamba2-1.3b, the reference's Pallas branches in interpret mode where its
own tests run them. Both packages start from the reference's round state,
carried across by ``models.convert``; the sgd round's initial state is
made by one jitted program (op by op it compiles for tens of seconds), the
demo's op by op, as the demo makes it.

Tolerances, each stated where it is used: whole sgd eq6 rounds (with and
without microbatches): params rtol 1e-4 / atol 1e-5, ``prev_sums`` rtol
1e-5 / atol 1e-5, losses rtol 1e-5; the adamw round's sign flips near zero
gradients are bounded and printed (its test says how); demo selection
lines: exact; ``fedavg_tree`` on the demo's state: the reference's rtol
1e-5 / atol 1e-6 (``tests/test_kernels.py``).
"""
import contextlib
import dataclasses
import importlib.util
import io
import re

import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import packing as jpacking
from repro.core import rounds as jrounds
from repro.data import pipeline as jpipeline
from repro.kernels import ops as jops
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.configs import get_arch
from repro_torch.core import rounds
from repro_torch.examples import compression_demo as demo
from repro_torch.models import convert, params
from repro_torch.optim import adamw, sgd
from test_torch_lm_train import ROOT, cfgs


# ------------------------------ rounds ---------------------------------------

C = 3


def _feds(**kw):
    base = dict(n_clients=C, local_steps=2, aggregation="eq6", topn=1, client_axis="data",
                data_axis=None)
    base.update(kw)
    return jrounds.FedConfig(**base), rounds.FedConfig(**base)


def carried_state(tcfg, st):
    """The reference's flat round state -> the port's, same numbers."""
    p, o = convert.state_from_reference(tcfg, np.asarray(st["params"]),
                                        jax.tree.map(np.asarray, st["opt"]))
    agg = convert.agg_state_from_reference(jax.tree.map(np.asarray, st["agg"]))
    return {"params": p, "opt": o, "agg": agg, "round": int(st["round"])}


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def demo_round():
    """The reference demo's round (its config, state from key 0, batch 2 of
    32, adamw 3e-3) and its printed output."""
    jfed, _ = _feds()
    jcfg = jget_arch("qwen3-1.7b").reduced()
    with jax.set_mesh(_mesh()):
        # op by op, as the demo makes it: its printed scores are of this state
        st0 = jrounds.make_state(jcfg, jfed, jadamw(3e-3), jax.random.key(0))
        fr = jax.jit(jrounds.build_fed_round(jcfg, jfed, jadamw(3e-3)))
        batch = next(jpipeline.fed_batches(jcfg, jfed, batch=2, seq=32))
        st1, m = fr(st0, jax.tree.map(jnp.asarray, batch), jrounds.uniform_weights(C))
    spec = importlib.util.spec_from_file_location("ref_compression_demo",
                                                  ROOT / "examples" / "compression_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    host = lambda t: jax.tree.map(np.asarray, t)
    return {"st0": host(st0), "st1": host(st1), "batch": batch, "loss": float(m["loss"]),
            "client_loss": np.asarray(m["client_loss"]), "printed": out.getvalue()}


def _assert_round_close(tstate, tm, st1, loss, client_loss):
    """sgd rounds: loss rtol 1e-5, params rtol 1e-4 / atol 1e-5, ``prev_sums``
    rtol 1e-5 with atol 1e-5: a bucket sum adds 10^5-10^6 f32 terms of about
    1e-2 in another order than XLA, about 1e-6 of absolute rounding, and a
    sum that cancels to 0.09 would miss a pure rtol 1e-5 on that alone."""
    np.testing.assert_allclose(float(tm["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(tm["client_loss"].numpy(), client_loss, rtol=1e-5)
    np.testing.assert_allclose(tstate["params"].numpy(), np.asarray(st1["params"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tstate["agg"]["prev_sums"].numpy(),
                               np.asarray(st1["agg"]["prev_sums"]), rtol=1e-5, atol=1e-5)


def test_eq6_sgd_round_at_the_demo_settings_matches_reference():
    """The demo's eq6 round (3 clients, 2 local steps, top-1, batch 2 of 32)
    with sgd: tight, as every gradient is."""
    jfed, tfed = _feds(agg_impl="kernel")
    jcfg, tcfg = cfgs("qwen3-1.7b", impl=False)
    with jax.set_mesh(_mesh()):
        st0 = jax.jit(lambda k: jrounds.make_state(jcfg, jfed, jsgd(1e-2), k))(jax.random.key(0))
        batch = next(jpipeline.fed_batches(jcfg, jfed, batch=2, seq=32))
        st1, m = jax.jit(jrounds.build_fed_round(jcfg, jfed, jsgd(1e-2)))(
            st0, jax.tree.map(jnp.asarray, batch), jrounds.uniform_weights(C))
    tstate = carried_state(tcfg, jax.tree.map(np.asarray, st0))
    tstate, tm = rounds.build_fed_round(tcfg, tfed, sgd(1e-2))(
        tstate, rounds.to_device(batch, "cpu"), rounds.uniform_weights(C))
    _assert_round_close(tstate, tm, jax.tree.map(np.asarray, st1), float(m["loss"]),
                        np.asarray(m["client_loss"]))


def test_eq6_round_at_the_demo_settings_matches_reference(demo_round, capsys):
    """The demo's own round, adamw 3e-3, from the reference's carried state,
    the aggregation through K1's path (its plain version here). adamw
    divides m by sqrt(v): where a gradient is near zero, a 1e-9 gap flips
    its sign and moves the step by up to 2 lr. The loss holds at rtol 1e-5
    and the moments at rtol 1e-4 / atol 1e-7; the params hold at rtol 1e-4 /
    atol 1e-5 except for fewer than 0.05% of elements (227 of 3,936,768,
    max gap 9.0e-4, on the machine that wrote this), and every element
    within 2 E lr = 0.012; ``prev_sums`` then at rtol 1e-3 (7.0e-5 seen).
    The gap is printed; the sgd test above holds the same round tight."""
    _, tfed = _feds(agg_impl="kernel")
    tcfg = dataclasses.replace(get_arch("qwen3-1.7b").reduced(), attention_impl="kernel")
    tstate = carried_state(tcfg, demo_round["st0"])
    fr = rounds.build_fed_round(tcfg, tfed, adamw(3e-3))
    tstate, tm = fr(tstate, rounds.to_device(demo_round["batch"], "cpu"), rounds.uniform_weights(C))
    st1 = demo_round["st1"]
    assert tstate["round"] == 1
    np.testing.assert_allclose(float(tm["loss"]), demo_round["loss"], rtol=1e-5)
    np.testing.assert_allclose(tm["client_loss"].numpy(), demo_round["client_loss"], rtol=1e-5)
    got, want = tstate["params"].numpy(), st1["params"]
    gap = np.abs(got - want)
    outside = gap > 1e-5 + 1e-4 * np.abs(want)
    with capsys.disabled():
        print(f"\nadamw eq6 round: {int(outside.sum())} of {gap.size} params outside rtol 1e-4 / "
              f"atol 1e-5, max gap {gap.max():.3e}")
    assert outside.mean() < 5e-4 and gap.max() <= 2 * tfed.local_steps * 3e-3
    np.testing.assert_allclose(tstate["agg"]["prev_sums"].numpy(), st1["agg"]["prev_sums"],
                               rtol=1e-3)
    jcfg = jget_arch("qwen3-1.7b").reduced()
    for k in ("m", "v"):  # the moments, packed, against the reference's trees: the
        # second step's gradient is taken where the first step's flips moved the
        # params, so rtol 1e-4 with an atol of 1e-3 of the moment's largest value
        ref = np.asarray(jpacking.pack(jpacking.build_pack_spec(jcfg, jT.template(jcfg)),
                                       st1["opt"][k]))
        np.testing.assert_allclose(tstate["opt"][k].numpy(), ref, rtol=1e-4,
                                   atol=1e-3 * np.abs(ref).max())
    assert tstate["opt"]["t"].tolist() == [2] * C


@pytest.mark.parametrize("arch", ["qwen3-1.7b"])
def test_microbatched_round_matches_reference(arch):
    """microbatches=2: each local step sums the two halves' gradients from
    zero and divides by 2 (the reference's scan), masked participation, sgd
    (tight; adamw's sign flips are the test above's)."""
    jfed, tfed = _feds(microbatches=2, participation="masked")
    jcfg, tcfg = cfgs(arch, impl=False)
    jopt, topt = jsgd(1e-2), sgd(1e-2)
    st0 = jax.jit(lambda k: jrounds.make_state(jcfg, jfed, jopt, k))(jax.random.key(1))
    batch = next(jpipeline.fed_batches(jcfg, jfed, batch=4, seq=16))
    m = np.array([1, 0, 1], np.float32)
    st1, jm = jax.jit(jrounds.build_fed_round(jcfg, jfed, jopt))(
        st0, jax.tree.map(jnp.asarray, batch), jrounds.participation_input(jfed, m, m / m.sum()))
    tstate = carried_state(tcfg, jax.tree.map(np.asarray, st0))
    tstate, tm = rounds.build_fed_round(tcfg, tfed, topt)(
        tstate, rounds.to_device(batch, "cpu"), rounds.participation_input(tfed, m, m / m.sum()))
    _assert_round_close(tstate, tm, jax.tree.map(np.asarray, st1), float(jm["loss"]),
                        np.asarray(jm["client_loss"]))


def test_microbatches_must_split_the_batch():
    _, tcfg = cfgs("mamba2-1.3b", impl=False)
    _, tfed = _feds(microbatches=3)
    state = rounds.make_state(tcfg, tfed, sgd(1e-2), device="cpu")
    batch = {"tokens": torch.zeros((C, 2, 4, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="microbatches"):
        rounds.build_fed_round(tcfg, tfed, sgd(1e-2))(state, batch, rounds.uniform_weights(C))


def test_lm_state_carry_over_round_trips_bit_exact(demo_round):
    tcfg = get_arch("qwen3-1.7b").reduced()
    st = demo_round["st1"]
    p, o = convert.state_from_reference(tcfg, st["params"], st["opt"])
    back_p, back_o = convert.state_to_reference(tcfg, p, o)
    assert np.array_equal(back_p, st["params"])
    for a, b in zip(jax.tree.leaves(back_o), jax.tree.leaves(st["opt"])):
        assert np.array_equal(a, b)


def test_demo_report_prints_the_references_lines(demo_round):
    """The demo's tail on the reference's carried before/after states prints
    the reference demo's selection lines and byte table exactly, the same
    uploaded-element count, and fedavg_tree equals the reference's."""
    _, tfed = _feds(agg_impl="kernel")
    tcfg = get_arch("qwen3-1.7b").reduced()
    before = torch.tensor(demo_round["st0"]["agg"]["prev_sums"])
    lines = []
    out = demo.report(tcfg, tfed, before, carried_state(tcfg, demo_round["st1"]), log=lines.append)
    got = "\n".join(lines).splitlines()
    want = demo_round["printed"].splitlines()
    assert len(got) == len(want) == 13
    assert got[:11] == want[:11]  # buckets, 3 clients, the byte table, blank lines
    count = lambda s: re.search(r"(\d+) tensors .* \((\d+), (\d+)\).* (\d+)/(\d+) elements", s).groups()
    assert count(got[11]) == count(want[11])  # leaves, buffer shape, uploaded elements
    assert got[12] == want[12]
    jstacked = jrounds.unpacked_params(jget_arch("qwen3-1.7b").reduced(), _feds()[0],
                                       {"params": jnp.asarray(demo_round["st1"]["params"])})
    jagg = jops.fedavg_tree(jstacked, jrounds.uniform_weights(C),
                            jax.tree.map(lambda _: jnp.ones(C), jstacked))
    jflat = dict(params.flatten_with_paths(jax.tree.map(np.asarray, jagg)))
    for path, x in params.flatten_with_paths(out["agg"]):
        np.testing.assert_allclose(x.numpy(), jflat[path], rtol=1e-5, atol=1e-6, err_msg=path)

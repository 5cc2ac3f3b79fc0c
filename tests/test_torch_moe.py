"""The port's GShard MoE (``repro_torch/models/moe.py``) held against the
reference's ``repro/models/moe.py`` on identical NumPy inputs, on the CPU.

Tolerances, each stated where it is used:

- the template, ``capacity`` and, on router logits with exact ties, the
  expert choices, slots and gates of ``route``: equal (``jax.lax.top_k``
  takes the lower index on a tie, and so does the port's ``top_k``);
- on random router logits the two softmaxes may differ in the last ulp,
  which flips a choice between two experts whose probabilities sit that
  close. Such routing flips are counted: at most 1 token in 1000 may route
  differently (measured 0 at these shapes), and every token that routes
  the same holds its combine weights at rtol 1e-6;
- ``moe_block`` (gshard and sort) at the prefill tolerance 5e-4 on the
  tokens that route the same, with its aux loss at 1e-6.
"""
import dataclasses

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro_torch.configs import get_arch
from repro_torch.models import convert, moe
from repro_torch.models.params import flatten_with_paths

FLIP_FRAC = 1e-3
# the reference's functions jitted whole: one compile per shape, not one per op
jroute = jax.jit(jmoe.route, static_argnums=0)
jmoe_block = jax.jit(jmoe.moe_block, static_argnums=2)


def cfgs(**kw):
    """(reference, port) configs: granite-moe-1b-a400m reduced (4 experts,
    top 2) unless ``kw`` widen it."""
    return (dataclasses.replace(jget_arch("granite-moe-1b-a400m").reduced(), **kw),
            dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(), **kw))


def test_template_and_capacity_match_reference():
    jcfg, tcfg = cfgs()
    want = jax.tree_util.tree_flatten_with_path(
        jmoe.moe_template(jcfg, ("layer",), (3,)), is_leaf=jparams.is_info)[0]
    got = dict(flatten_with_paths(moe.moe_template(tcfg, ("layer",), (3,))))
    assert len(got) == len(want)
    for path, info in want:
        t = got["/".join(p.key for p in path)]
        assert (t.shape, t.axes, t.init, t.scale) == (info.shape, info.axes, info.init, info.scale)
    for kw in ({}, dict(n_experts=32, experts_per_token=8), dict(n_experts=8, experts_per_token=2)):
        j, t = cfgs(**kw)
        for gs in (1, 7, 64, 512, 1024, 4096):
            assert moe.capacity(t, gs) == jmoe.capacity(j, gs)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25], [0.4, 0.1, 0.4, 0.1]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _route_both(jcfg, tcfg, logits):
    jd, jc, ja = jroute(jcfg, jnp.asarray(logits))
    td, tc, ta = moe.route(tcfg, torch.from_numpy(logits))
    return (np.asarray(jd), np.asarray(jc), float(ja)), (td.numpy(), tc.numpy(), float(ta))


@pytest.mark.parametrize("E,k,S,tied", [(4, 2, 64, True), (32, 8, 512, True), (4, 2, 64, False),
                                        (32, 8, 512, False), (8, 2, 1024, False)])
def test_route_matches_reference(E, k, S, tied):
    """Expert choices, capacity slots and gates: equal on tied logits;
    on random ones, routing flips counted and bounded."""
    jcfg, tcfg = cfgs(n_experts=E, experts_per_token=k)
    rng = np.random.default_rng(E * 1000 + S)
    logits = rng.standard_normal((3, S, E)).astype(np.float32)
    if tied:  # half-unit steps: many exact ties between experts
        logits = np.round(logits * 2) / 2
    (jd, jc, ja), (td, tc, ta) = _route_both(jcfg, tcfg, logits)
    assert td.shape == jd.shape == (3, S, E, moe.capacity(tcfg, S))
    same = (td == jd).all(axis=(2, 3))  # (G, S): this token's experts and slots agree
    flips = int((~same).sum())
    print(f"route E={E} k={k} S={S} tied={tied}: {flips} of {same.size} tokens route differently, "
          f"aux gap {abs(ta - ja):.2e}")
    if tied:
        assert flips == 0
    assert flips <= FLIP_FRAC * same.size
    np.testing.assert_allclose(tc[same], jc[same], rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    # a token past its expert's capacity has no slot there: each expert's
    # queue is full up to C and no slot holds two tokens
    assert (td.sum(axis=1) <= 1).all() and (td.sum(axis=(1, 3)) <= moe.capacity(tcfg, S)).all()


def _moe_weights(jcfg, seed):
    jp = jparams.init_params(jmoe.moe_template(jcfg, (), ()), jax.random.key(seed), jnp.float32)
    return jp, convert.lm_params_from_reference(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("impl,S,group", [("gshard", 64, 4096), ("gshard", 64, 16),
                                          ("gshard", 60, 16), ("sort", 64, 4096), ("sort", 1, 4096)])
def test_moe_block_matches_reference(impl, S, group):
    """gshard over one group, over groups of 16, and a length the group
    size does not divide (one group); the sort path; a decode step's one
    token. Held on the tokens whose routing agrees (all of them here)."""
    jcfg, tcfg = cfgs(moe_impl=impl, moe_group_size=group)
    jp, tp = _moe_weights(jcfg, seed=S)
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe_block(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        ty, taux = moe.moe_block(tp, torch.from_numpy(x), tcfg)
        logits = torch.einsum("bsd,de->bse", torch.from_numpy(x), tp["router"])
    jchoice = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"]), axis=-1), jcfg.experts_per_token)[1])
    tchoice = moe.top_k(torch.softmax(logits, -1), tcfg.experts_per_token)[1].numpy()
    same = (np.sort(jchoice, -1) == np.sort(tchoice, -1)).all(-1)
    print(f"moe_block {impl} S={S} group={group}: {int((~same).sum())} of {same.size} tokens route "
          f"differently; output gap {float(np.abs(ty.numpy() - np.asarray(jy))[same].max()):.2e}")
    assert (~same).sum() <= FLIP_FRAC * same.size
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty.numpy()[same], np.asarray(jy)[same], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_overflow_tokens_get_zero_expert_output():
    """Every token routed to expert 0 (top 1): past the capacity C the
    tokens get nothing, in both dispatch paths and in the reference."""
    for impl in ("gshard", "sort"):
        jcfg, tcfg = cfgs(moe_impl=impl, experts_per_token=1, n_experts=4)
        jp, tp = _moe_weights(jcfg, seed=2)
        router = np.zeros_like(np.asarray(jp["router"]))
        router[:, 0] = 1.0
        jp = dict(jp, router=jnp.asarray(router))
        tp = dict(tp, router=torch.from_numpy(router))
        x = np.abs(np.random.default_rng(5).standard_normal((1, 32, jcfg.d_model))).astype(np.float32)
        C = moe.capacity(tcfg, 32)
        with torch.no_grad():
            ty, _ = moe.moe_block(tp, torch.from_numpy(x), tcfg)
        jy, _ = jmoe_block(jp, jnp.asarray(x), jcfg)
        assert C < 32 and (ty[0, C:] == 0).all() and (ty[0, :C] != 0).any(), impl
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=5e-4, atol=5e-4)

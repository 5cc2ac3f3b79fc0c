"""Two flat rounds of each compressed, secure and edge-grouped uplink mode
(quant8, quant4, secure, topk_ef, hier) in the port against the reference
from its carried state, on ``tests/test_torch_aggregation.py``'s
configuration (fedyolov3 cut to base width 8 and 3 stages, 32x32 images).

Tolerances: the loss rtol 1e-5, params rtol 1e-4 / atol 1e-6, as
``tests/test_torch_train_rounds.py`` holds the eq6 rounds. Under a rounding
mode (quant8, quant4, secure) the two packages' local training differs by
about 1e-7 relative, which flips a rounding decision that sits that close
to a half step (measured: one element of 161,928, whose x/s was
7.5000067): at most 1 element in 10^4 may then differ, by at most one
quantization step (below 1e-5 at this lr; measured 3.9e-6).
"""
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core import rounds as jrounds
from repro.data import pipeline as jpipeline
from repro.optim import sgd as jsgd
from repro_torch.core import rounds
from repro_torch.models import convert
from repro_torch.optim import sgd
from test_torch_aggregation import IMG, JCFG, TCFG


# ------------------------------ two rounds ----------------------------------

TWO_ROUND_MODES = {
    "quant8": {},
    "quant4": dict(quant4_mode="stochastic", quant4_seed=4),
    "secure": dict(secure_domain="int8", secure_session=6),
    "topk_ef": dict(topk_frac=0.2),
    "hier": dict(n_clients=4, group_size=2, hier_base="eq6"),
}


@pytest.mark.parametrize("mode", sorted(TWO_ROUND_MODES))
def test_two_flat_rounds_match_reference_per_mode(mode):
    """Two masked rounds: the second round's deltas are taken against the
    first round's dispatch, so a base row that aliased the round buffer
    (which local training rewrites in place) would show here."""
    kw = {"n_clients": 3, **TWO_ROUND_MODES[mode]}
    C = kw["n_clients"]
    common = dict(local_steps=2, aggregation=mode, topn=4, client_axis="data", data_axis=None,
                  participation="masked", **kw)
    jfed = jrounds.FedConfig(**common)
    tfed = rounds.FedConfig(agg_impl="kernel", **common)
    st = jax.jit(lambda k: jrounds.make_state(JCFG, jfed, jsgd(1e-2), k))(jax.random.key(0))
    p, o = convert.state_from_reference(TCFG, np.asarray(st["params"]),
                                        jax.tree.map(np.asarray, st["opt"]))
    tstate = {"params": p, "opt": o, "round": int(st["round"]),
              "agg": convert.agg_state_from_reference(jax.tree.map(np.asarray, st["agg"]))}
    jround = jax.jit(jrounds.build_fed_round(JCFG, jfed, jsgd(1e-2)))
    tround = rounds.build_fed_round(TCFG, tfed, sgd(1e-2))
    gen, _, _ = jpipeline.detection_suite(JCFG, jfed, batch=2, img_size=IMG, pool_scenes=24)
    masks = [np.array([1, 0, 1, 1][:C], np.float32), np.array([0, 1, 1, 0][:C], np.float32)]
    for r in range(2):
        b, m = next(gen), masks[r]
        st, jm = jround(st, jax.tree.map(jnp.asarray, b),
                        jrounds.participation_input(jfed, m, m / m.sum()))
        tstate, tm = tround(tstate, rounds.to_device(b, "cpu"),
                            rounds.participation_input(tfed, m, m / m.sum()))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        back = convert.agg_state_to_reference(tstate["agg"])
        pairs = [("params", tstate["params"].numpy(), np.asarray(st["params"]))]
        pairs += [(str(path), a, np.asarray(b_)) for (path, a), b_ in
                  zip(jax.tree_util.tree_flatten_with_path(back)[0], jax.tree.leaves(st["agg"]))]
        for name, a, b_ in pairs:
            if a.dtype.kind != "f":
                np.testing.assert_array_equal(a, b_, err_msg=name)
                continue
            off = ~np.isclose(a, b_, rtol=1e-4, atol=1e-6)
            flips = int(off.sum()) if mode in ("quant8", "quant4", "secure") else 0
            assert off.sum() <= flips <= 1e-4 * a.size, (name, int(off.sum()))
            np.testing.assert_allclose(a[off], b_[off], rtol=0, atol=1e-5, err_msg=name)
    # the carried base is the dispatch, not a view of the trained buffer
    if "base" in tstate["agg"]:
        assert tstate["agg"]["base"].data_ptr() != tstate["params"][0].data_ptr()

"""One sgd eq6 round of every LM family in the port against the reference,
both packages from one round state (the port's, carried to the reference
by ``models.convert``), on ``tests/test_torch_lm_families_train.py``'s
cases and configs; and the launcher over the registry's 10 LM archs.

Tolerances: ``tests/test_torch_lm_train_rounds.py``'s bounds (loss and
client losses rtol 1e-5, params rtol 1e-4 / atol 1e-5, ``prev_sums`` rtol
1e-5 / atol 1e-5).
"""
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import rounds as jrounds
from repro.data import pipeline as jpipeline
from repro.optim import sgd as jsgd
from repro_torch import configs
from repro_torch.core import rounds
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.optim import sgd
from test_torch_lm_families_train import C, CASES, IDS, cfgs


# ------------------------------ one round ------------------------------------

@pytest.mark.parametrize("case,arch,kw", CASES, ids=IDS)
def test_eq6_sgd_round_matches_reference(case, arch, kw):
    """One eq6 round (2 clients, 2 local steps, top-1, batch 2 of 32
    positions from ``fed_batches``) with sgd, both packages from one state
    (the port's, carried to the reference by ``models.convert``)."""
    jcfg, tcfg = cfgs(arch, **kw)
    base = dict(n_clients=C, local_steps=2, aggregation="eq6", topn=1, client_axis="data",
                data_axis=None)
    jfed, tfed = jrounds.FedConfig(**base), rounds.FedConfig(**base, agg_impl="kernel")
    tstate = rounds.make_state(tcfg, tfed, sgd(1e-2), torch.Generator().manual_seed(0), "cpu")
    jp, jo = convert.state_to_reference(tcfg, tstate["params"], tstate["opt"])
    st0 = jax.tree.map(np.array, {"params": jp, "opt": jo, "round": np.int32(0),  # copies:
                                  "agg": convert.agg_state_to_reference(tstate["agg"])})
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        batch = next(jpipeline.fed_batches(jcfg, jfed, batch=2, seq=32))
        st1, m = jax.jit(jrounds.build_fed_round(jcfg, jfed, jsgd(1e-2)))(
            jax.tree.map(jnp.asarray, st0), jax.tree.map(jnp.asarray, batch),
            jrounds.uniform_weights(C))
    st1 = jax.tree.map(np.asarray, st1)
    tbatch = next(pipeline.fed_batches(tcfg, tfed, batch=2, seq=32))
    tstate, tm = rounds.build_fed_round(tcfg, tfed, sgd(1e-2))(
        tstate, rounds.to_device(tbatch, "cpu"), rounds.uniform_weights(C))
    np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["client_loss"].numpy(), np.asarray(m["client_loss"]), rtol=1e-5)
    np.testing.assert_allclose(tstate["params"].numpy(), st1["params"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tstate["agg"]["prev_sums"].numpy(), st1["agg"]["prev_sums"],
                               rtol=1e-5, atol=1e-5)
    assert float(np.abs(tstate["params"].numpy() - st0["params"]).max()) > 1e-4  # it trained


# ------------------------------ every LM arch --------------------------------

@pytest.mark.parametrize("arch", [c.name for c in configs.ASSIGNED])
def test_every_lm_arch_trains_through_the_launcher(arch, capsys):
    """``train --task lm --device cpu --arch <arch> --rounds 2`` for each of
    the registry's 10 LM archs, reduced: the reference's JSON keys and a
    finite loss (``rounds.make_template`` and ``loss_for`` under it)."""
    cfg = configs.get_arch(arch).reduced()
    assert rounds.make_template(cfg) and callable(rounds.loss_for(cfg))
    summary = train.main(["--task", "lm", "--arch", arch, "--device", "cpu", "--rounds", "2",
                          "--clients", "2", "--batch", "1", "--seq", "32"])
    assert set(summary) >= {"final_loss", "rounds", "participation", "mean_participants"}
    assert summary["rounds"] == 2 and np.isfinite(summary["final_loss"])
    assert '"final_loss"' in capsys.readouterr().out.splitlines()[-1]

"""The port's training path for every LM family (``transformer.trunk`` and
``loss_fn``, ``models/moe.py`` under autograd, ``data.synthetic.audio_batches``,
``fed_batches``' audio and vlm branches) held against the reference on
the CPU.

The cases are ``tests/test_torch_lm_families.py``'s serving families plus
hubert: the GShard MoE (granite-moe-1b-a400m, gshard and sort), gemma3 at 8
layers (a period group and a 2-layer tail), zamba2 at 4 layers (2 Mamba2
groups, the shared block applied twice), llava with 6 q heads over 2 kv
heads padded to 4 a group (2 dead heads), minitron's untied head and
hubert's masked-frame CE (non-causal). Both packages start from one set
of weights or one round state (drawn by the port, carried to the reference
by ``models.convert``); batches come from the same NumPy seeds. The reference runs its Pallas
branches in interpret mode where its own tests do (``attention_impl`` /
``ssm_impl = "pallas"``), its functions jitted whole; the port runs its
``"kernel"`` branches, the plain versions of K9 and K10 on the CPU.
Tolerances, each stated where it is used:

- audio and vlm batches: bit-identical;
- MoE: the experts every token routes to, in order, at every layer, equal
  in both packages (so the GShard queues and capacity drops are equal);
  the flips are counted and printed before the assertion;
- one step's loss, ce and aux: rtol 1e-5; its gradients rtol 1e-4 / atol
  1e-6 (``tests/test_torch_lm_train.py``'s bounds); the dead heads' ``wq``
  gradient exactly 0 in both packages;
- one sgd eq6 round per family and the launcher over every LM arch:
  ``tests/test_torch_lm_families_rounds.py``.
"""
import dataclasses

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import rounds as jrounds
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.core import rounds
from repro_torch.data import pipeline, synthetic
from repro_torch.models import attention as attn
from repro_torch.models import convert, moe, params
from repro_torch.models import transformer as T
from repro_torch.models.layers import einsum, rms_norm
from test_torch_lm_families import FAMILIES

# the serving families, zamba2 at 4 layers (2 groups), and hubert
CASES = [(c, a, dict(kw, n_layers=4) if c == "hybrid" else kw) for c, a, kw in FAMILIES]
CASES.append(("audio", "hubert-xlarge", {}))
IDS = [c[0] for c in CASES]
B, SEQ = 2, 128  # 128 positions: the K9 branch of every causal attention layer
C = 2


def cfgs(arch, **kw):
    """(reference cfg on its Pallas branches, port cfg on its kernel branches), reduced."""
    j = dataclasses.replace(jget_arch(arch).reduced(), attention_impl="pallas", ssm_impl="pallas",
                            **kw)
    t = dataclasses.replace(configs.get_arch(arch).reduced(), attention_impl="kernel",
                            ssm_impl="kernel", **kw)
    return j, t


def weights(tcfg, seed=1):
    """(reference tree of NumPy arrays, port tree of tensors) of the same
    weights, drawn by the port's ``init_params``."""
    tp = params.init_params(T.template(tcfg), torch.Generator().manual_seed(seed))
    return convert.lm_params_to_reference(tp), tp


def batch_of(cfg, seed=3) -> dict:
    """One step's NumPy batch of SEQ positions: tokens (and llava's image
    embeddings first), or hubert's frames, labels and mask."""
    if cfg.modality == "audio":
        b = next(synthetic.audio_batches(cfg.d_model, cfg.vocab_size, 1, 1, B, SEQ, seed))
        return {k: v[0, 0] for k, v in b.items()}
    rng = np.random.default_rng(seed)
    ni = cfg.n_image_tokens if cfg.modality == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ - ni)).astype(np.int32)}
    if ni:
        out["images"] = (rng.standard_normal((B, ni, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def ref_choices(cfg, p, batch) -> list:
    """The ordered top-k experts of every token at every MoE layer, (B, S, k)
    each, from the reference's forward layer by layer."""
    k, eps = cfg.experts_per_token, cfg.norm_eps
    x = jT.embed_inputs(cfg, p, batch)
    out = []
    for i in range(cfg.n_layers):
        q = jax.tree.map(lambda w: w[i], p["layers"])
        h = x + jattn.attention_block(q["attn"], jlayers.rms_norm(x, q["norm1"], eps), cfg,
                                      window=cfg.window)
        logits = jnp.einsum("bsd,de->bse", jlayers.rms_norm(h, q["norm2"], eps), q["moe"]["router"])
        out.append(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)[1])
        x, _ = jT._dense_block(cfg, q, x, cfg.window)
    return out


def port_choices(cfg, p, batch) -> list[np.ndarray]:
    """:func:`ref_choices` through the port."""
    k, eps = cfg.experts_per_token, cfg.norm_eps
    out = []
    with torch.no_grad():
        x = T.embed_inputs(cfg, p, {n: torch.from_numpy(v) for n, v in batch.items()})
        for q in T.unstack(p["layers"]):
            h = x + attn.attention_block(q["attn"], rms_norm(x, q["norm1"], eps), cfg,
                                         window=cfg.window)
            logits = einsum("bsd,de->bse", rms_norm(h, q["norm2"], eps), q["moe"]["router"])
            out.append(moe.top_k(torch.softmax(logits, -1), k)[1].numpy())
            x, _ = T.dense_block(cfg, q, x, cfg.window)
    return out


def _port_step(tcfg, tp, batch):
    """(loss, metrics, {path: gradient}); a leaf the loss does not read
    (hubert's token embedding) gets zeros, as ``jax.grad`` gives it."""
    tp = params.map_tree(lambda w: w.clone().requires_grad_(True), tp)
    loss, metrics = T.loss_fn(tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    leaves = list(params.flatten_with_paths(tp))
    grads = torch.autograd.grad(loss, [w for _, w in leaves], allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        p: torch.zeros_like(w) if g is None else g for (p, w), g in zip(leaves, grads)}


# ------------------------------ data -----------------------------------------

def test_audio_batches_are_bit_identical():
    for args in [(32, 504, 2, 2, 3, 16, 0), (256, 40, 1, 1, 2, 7, 5)]:
        a, b = jsynthetic.audio_batches(*args), synthetic.audio_batches(*args)
        for _ in range(2):
            x, y = next(a), next(b)
            assert sorted(x) == sorted(y) == ["frames", "labels", "mask"]
            for k in x:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
                assert np.array_equal(x[k].view(np.uint8), y[k].view(np.uint8)), k


@pytest.mark.parametrize("arch,seq", [("llava-next-34b", 48), ("llava-next-34b", 20),
                                      ("hubert-xlarge", 24)])
def test_fed_batches_of_vlm_and_audio_are_bit_identical(arch, seq):
    """llava's tokens (``max(seq - ni, 8)`` of them: 32 and, past the floor,
    8) beside its image embeddings, and hubert's frames, over 2 rounds."""
    jcfg, tcfg = jget_arch(arch).reduced(), configs.get_arch(arch).reduced()
    jfed = jrounds.FedConfig(n_clients=3, local_steps=2)
    tfed = rounds.FedConfig(n_clients=3, local_steps=2)
    a = jpipeline.fed_batches(jcfg, jfed, batch=2, seq=seq, seed=4)
    b = pipeline.fed_batches(tcfg, tfed, batch=2, seq=seq, seed=4)
    for _ in range(2):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape[:3] == (3, 2, 2), k
            assert np.array_equal(x[k].view(np.uint8), y[k].view(np.uint8)), k
    if tcfg.modality == "vlm":
        assert y["tokens"].shape[-1] == max(seq - tcfg.n_image_tokens, 8)
        assert y["images"].shape[-2:] == (tcfg.n_image_tokens, tcfg.d_model)


@pytest.mark.parametrize("arch", ["llava-next-34b", "hubert-xlarge"])
def test_a_partition_scenario_on_a_non_text_arch_raises_as_the_reference(arch):
    jcfg, tcfg = jget_arch(arch).reduced(), configs.get_arch(arch).reduced()
    with pytest.raises(ValueError) as want:
        next(jpipeline.fed_batches(jcfg, jrounds.FedConfig(n_clients=2), batch=1, seq=8,
                                   partition_name="dirichlet"))
    with pytest.raises(ValueError) as got:
        next(pipeline.fed_batches(tcfg, rounds.FedConfig(n_clients=2), batch=1, seq=8,
                                  partition_name="dirichlet"))
    assert str(got.value) == str(want.value) and "stream" in str(got.value)


# ------------------------------ one step -------------------------------------

@pytest.mark.parametrize("case,arch,kw", CASES, ids=IDS)
def test_one_step_loss_and_grads_match_reference(case, arch, kw):
    jcfg, tcfg = cfgs(arch, **kw)
    jp, tp = weights(tcfg)
    batch = batch_of(tcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    if tcfg.family == "moe":
        want = jax.jit(lambda p, b: ref_choices(jcfg, p, b))(jp, jb)
        got = port_choices(tcfg, tp, batch)
        flips = sum(int((np.asarray(a) != b).any(-1).sum()) for a, b in zip(want, got))
        print(f"{case}: {flips} of {B * SEQ * tcfg.n_layers} token-layers route differently")
        assert flips == 0
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: jT.loss_fn(jcfg, p, jb), has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    loss, metrics, grads = _port_step(tcfg, tp, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]), rtol=1e-5)
    assert (float(metrics["aux"]) > 0) == (tcfg.family == "moe")
    jflat = dict(params.flatten_with_paths(jax.tree.map(np.asarray, jg)))
    assert sorted(jflat) == sorted(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[path], rtol=1e-4, atol=1e-6, err_msg=path)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-2  # not trivially small
    if tcfg.q_group_pad:  # the dead heads (index % pad >= real) get no gradient
        real = tcfg.n_heads // tcfg.n_kv_heads
        dead = np.arange(attn.eff_heads(tcfg)) % tcfg.q_group_pad >= real
        assert dead.sum() == 2
        for g in (grads["layers/attn/wq"].numpy(), jflat["layers/attn/wq"]):
            assert not g[:, :, dead].any() and g[:, :, ~dead].any()


def test_kernel_forward_runs_twice_per_attention_layer_per_step(monkeypatch):
    """zamba2 at 4 layers: each Mamba2 group and the shared block after it is
    one checkpointed unit, so a step calls K10's wrapper twice per Mamba2
    layer and K9's twice per application of the shared block; gemma3 at 8
    layers (a group of 6 and a tail of 2): K9 twice per layer, the windowed
    ones included. hubert's non-causal attention never calls K9."""
    from repro_torch.kernels import ops as kops

    calls = {"flash_attention": 0, "ssd_chunk_scan": 0}
    for mod, name in ((kops._flash, "flash_attention"), (kops._ssd, "ssd_chunk_scan")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw:
                            calls.__setitem__(_n, calls[_n] + 1) or _r(*a, **kw))
    for arch, kw, want in (("zamba2-2.7b", {"n_layers": 4}, (4, 8)),
                           ("gemma3-27b", {"n_layers": 8}, (16, 0)), ("hubert-xlarge", {}, (0, 0))):
        _, tcfg = cfgs(arch, **kw)
        _, tp = weights(tcfg)
        calls.update(flash_attention=0, ssd_chunk_scan=0)
        _port_step(tcfg, tp, batch_of(tcfg))
        assert (calls["flash_attention"], calls["ssd_chunk_scan"]) == want, arch

"""The port's LM training path (token data, the CE loss, K9/K10 under
autograd, the checkpointed trunk, the LM pack spec and the launcher) held
against the reference on the CPU, with the two slice-7a faults' repairs
(F1, F2).

Both packages start from the reference's own weights or round state,
carried across by ``models.convert``; tokens come from the same NumPy seeds.
The configs are the reduced qwen3-1.7b (2 layers, d_model 256, GQA 4/2,
head_dim 64) and mamba2-1.3b (2 layers, 16 heads of 32, state 16, chunk 8).
Where the reference reaches a Pallas kernel (``attention_impl`` /
``ssm_impl = "pallas"``) it runs in interpret mode, as its own tests run
it; the port's ``"kernel"`` branch then runs the plain versions on the CPU.
Tolerances, each stated where it is used:

- token batches, pack specs, demo selection lines: exact;
- one step's loss: rtol 1e-5; its gradients: rtol 1e-4 / atol 1e-6;
- the autograd Functions against autograd of the plain versions: bitwise;
- whole eq6 rounds, the demo's report and ``fedavg_tree`` on its state:
  ``tests/test_torch_lm_train_rounds.py``.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import packing as jpacking
from repro.core import rounds as jrounds
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import params as jparams
from repro.models import transformer as jT
from repro_torch.configs import get_arch
from repro_torch.core import compression, packing, rounds
from repro_torch.data import pipeline, synthetic
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import serve, train
from repro_torch.models import convert, mamba2, params
from repro_torch.models import transformer as T
from repro_torch.optim import sgd

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-1.7b", "mamba2-1.3b"]
# qwen3 at 128 tokens takes the K9 branch; mamba2's chunk is 8, so 32 tokens
# take the K10 branch
SEQ = {"qwen3-1.7b": 128, "mamba2-1.3b": 32}


def cfgs(arch, impl=True):
    """(reference cfg, port cfg), reduced; ``impl`` selects the kernel branches."""
    j, t = jget_arch(arch).reduced(), get_arch(arch).reduced()
    if impl:
        j = dataclasses.replace(j, attention_impl="pallas", ssm_impl="pallas")
        t = dataclasses.replace(t, attention_impl="kernel", ssm_impl="kernel")
    return j, t


def weights(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, jparams.init_params(jT.template(jcfg), jax.random.key(seed),
                                                      jnp.float32))
    return jp, convert.lm_params_from_reference(jp)


def tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def slot_path(keystr: str) -> str:
    """The reference's ``['layers']['attn']['wq']`` -> ``layers/attn/wq``."""
    return "/".join(a or b for a, b in re.findall(r"\['([^']*)'\]|\[(\d+)\]", keystr))


# ------------------------------ data -----------------------------------------

def test_token_batches_are_bit_identical():
    for args in [(512, 3, 2, 2, 32, 0), (50280, 2, 1, 3, 17, 4)]:
        a, b = jsynthetic.token_batches(*args), synthetic.token_batches(*args)
        for _ in range(2):
            x, y = next(a)["tokens"], next(b)["tokens"]
            assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)
    for scenario in ("dirichlet", "shards"):
        a = jpipeline.partitioned_token_batches(512, 3, 2, 2, 16, scenario, 1)
        b = pipeline.partitioned_token_batches(512, 3, 2, 2, 16, scenario, 1)
        for _ in range(2):
            assert np.array_equal(next(a)["tokens"], next(b)["tokens"])
    jcfg, tcfg = cfgs("qwen3-1.7b", impl=False)
    for part in ("stream", "quantity"):
        jfed = jrounds.FedConfig(n_clients=3, local_steps=2)
        tfed = rounds.FedConfig(n_clients=3, local_steps=2)
        a = jpipeline.fed_batches(jcfg, jfed, batch=2, seq=32, partition_name=part)
        b = pipeline.fed_batches(tcfg, tfed, batch=2, seq=32, partition_name=part)
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.shape == (3, 2, 2, 32) and np.array_equal(x, y)


# ------------------------------ pack spec ------------------------------------

# N_total of every LM arch at full size (the port's count_params of its template)
FULL_N = {"granite-3-8b": 8_170_901_504, "qwen3-1.7b": 1_720_574_976,
          "hubert-xlarge": 1_259_726_080, "grok-1-314b": 315_684_034_560,
          "granite-moe-1b-a400m": 1_334_641_664, "gemma3-27b": 27_008_335_616,
          "llava-next-34b": 34_862_349_312, "minitron-8b": 9_882_046_464,
          "mamba2-1.3b": 1_343_548_416, "zamba2-2.7b": 2_340_466_848}


@pytest.mark.parametrize("arch", list(FULL_N))
def test_full_size_pack_spec_matches_reference(arch):
    """The leaf order (sorted keys) and the Eq. 6 buckets K1 reduces over, at
    full size, for every LM arch: both specs read templates only."""
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    js = jpacking.build_pack_spec(jcfg, jT.template(jcfg))
    ts = packing.build_pack_spec(tcfg, T.template(tcfg))
    want = [(slot_path(s.name), s.shape, s.offset, s.size, s.bucket_off, s.n_buckets)
            for s in js.slots]
    got = [(s.name, s.shape, s.offset, s.size, s.bucket_off, s.n_buckets) for s in ts.slots]
    assert got == want
    assert ts.n_total == js.n_total and ts.n_buckets == js.n_buckets == tcfg.n_layers + 1
    # one bucket per layer of every layer stack (gemma3's tail after its
    # groups), the misc bucket for the rest (zamba2's shared block included)
    grouped = tcfg.n_layers // (tcfg.local_global_period or tcfg.shared_attn_period or 1)
    grouped *= tcfg.local_global_period or tcfg.shared_attn_period or 1
    for s in ts.slots:
        top = s.name.split("/")[0]
        if top == "layers":
            assert (s.bucket_off, s.n_buckets) == (0, tcfg.n_layers)
        elif top in ("groups", "mamba_groups"):
            assert (s.bucket_off, s.n_buckets) == (0, grouped)
        elif top == "tail":
            assert (s.bucket_off, s.n_buckets) == (grouped, tcfg.n_layers - grouped)
        else:
            assert (s.bucket_off, s.n_buckets) == (tcfg.n_layers, 1)
    assert ts.n_total == FULL_N[arch]
    assert compression.compression_ratio(tcfg, 1) == 1 / (tcfg.n_layers + 1)


def test_bucket_ids_built_on_the_device_equal_the_host_ids():
    """K1's (N,) bucket-id operand, built with torch where it is used, equals
    the host build that tests/test_torch_data.py holds to the reference."""
    for arch in (*ARCHS, "fedyolov3"):
        cfg = get_arch(arch).reduced()
        spec = packing.build_pack_spec(cfg, rounds.make_template(cfg))
        ids = packing.bucket_ids_on(spec, torch.device("cpu"))
        assert ids.dtype == torch.int32 and np.array_equal(ids.numpy(), packing.bucket_ids(spec))


# ------------------------------ loss and gradients ---------------------------

def test_softmax_cross_entropy_matches_reference():
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jlayers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                             None if m is None else jnp.asarray(m))
        got = layers.softmax_cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                           None if m is None else torch.tensor(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # the gathered gold logit is the reference's masked reduction bit for bit
    sel = (np.arange(33)[None, None] == labels[..., None]).astype(np.float32)
    assert np.array_equal(layers.gold_logit(torch.tensor(logits), torch.tensor(labels)).numpy(),
                          np.sum(logits * sel, axis=-1))


def _loss_and_grads(tcfg, tp, toks):
    tp = params.map_tree(lambda w: w.clone().requires_grad_(True), tp)
    loss, metrics = T.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    leaves = [w for _, w in params.flatten_with_paths(tp)]
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_loss_and_grads_match_reference(arch):
    """The kernel branch (K9 / K10 through their autograd Functions, the
    layers and the CE chunks checkpointed) against the reference's Pallas
    branch, value and gradients."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = weights(jcfg)
    toks = tokens(tcfg, 2, SEQ[arch])
    (jl, jm), jg = jax.value_and_grad(lambda p: jT.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
                                      has_aux=True)(jax.tree.map(jnp.asarray, jp))
    loss, metrics, grads = _loss_and_grads(tcfg, tp, toks)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]), rtol=1e-5)
    jflat = [g for _, g in params.flatten_with_paths(convert.lm_params_to_reference(
        convert.lm_params_from_reference(jax.tree.map(np.asarray, jg))))]
    for (path, _), a, b in zip(params.flatten_with_paths(tp), grads, jflat):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6, err_msg=path)
    assert max(float(g.abs().max()) for g in grads) > 1e-2  # not trivially small


def test_chunked_ce_matches_reference_over_several_chunks(monkeypatch):
    """CE over 3 chunks (CE_CHUNK shrunk to 32 in both packages), each
    recomputed in the backward."""
    monkeypatch.setattr(jT, "CE_CHUNK", 32)
    monkeypatch.setattr(T, "CE_CHUNK", 32)
    jcfg, tcfg = cfgs("qwen3-1.7b", impl=False)
    jp, tp = weights(jcfg, seed=3)
    toks = tokens(tcfg, 2, 96)
    (jl, _), jg = jax.value_and_grad(lambda p: jT.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
                                     has_aux=True)(jax.tree.map(jnp.asarray, jp))
    loss, _, grads = _loss_and_grads(tcfg, tp, toks)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg["embed"]), rtol=1e-4, atol=1e-6)


def test_autograd_functions_are_autograd_of_the_plain_versions():
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=s).astype(np.float32), requires_grad=True)
               for s in ((2, 4, 64, 16), (2, 2, 64, 16), (2, 2, 64, 16)))
    g = torch.tensor(rng.normal(size=(2, 4, 64, 16)).astype(np.float32))
    for window in (0, 24):
        out = kops.flash_attention_trainable(q, k, v, causal=True, window=window)
        want = kref.flash_attention(q, k, v, True, window)
        assert torch.equal(out, want)
        got = torch.autograd.grad(out, (q, k, v), g)
        ref = torch.autograd.grad(want, (q, k, v), g)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    xdt, dA, Bm, Cm = (torch.tensor(a, requires_grad=True) for a in (
        rng.normal(size=(2, 32, 3, 4)).astype(np.float32) * 0.1,
        -np.abs(rng.normal(size=(2, 32, 3))).astype(np.float32) * 0.1,
        rng.normal(size=(2, 32, 5)).astype(np.float32),
        rng.normal(size=(2, 32, 5)).astype(np.float32)))
    gy = torch.tensor(rng.normal(size=(2, 32, 3, 4)).astype(np.float32))
    gs = torch.tensor(rng.normal(size=(2, 3, 4, 5)).astype(np.float32))
    with torch.no_grad():
        y0, st0 = kops.ssd_full(xdt, dA, Bm, Cm, chunk=8)
    for gouts in ((gy,), (gy, gs)):  # the final state unused, then used
        y, st = kops.ssd_full_trainable(xdt, dA, Bm, Cm, chunk=8)
        assert torch.equal(y, y0) and torch.equal(st, st0)
        got = torch.autograd.grad((y, st)[:len(gouts)], (xdt, dA, Bm, Cm), gouts)
        yr, sr = mamba2.ssd_chunked(xdt, dA, Bm, Cm, 8)
        ref = torch.autograd.grad((yr, sr)[:len(gouts)], (xdt, dA, Bm, Cm), gouts)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """At a full-width chunk of 128 with dA about -0.8, exp(cum[q] - cum[t])
    overflows float32 above the diagonal. The reference's
    ``where(tri, exp(diff), 0)`` keeps the forward right but backpropagates
    0 * inf = NaN there (its gradient is NaN below); the port masks before
    the exp: the same forward, every gradient finite."""
    from repro.models import mamba2 as jm2

    rng = np.random.default_rng(4)
    xdt = rng.normal(size=(1, 128, 2, 4)).astype(np.float32) * 0.1
    dA = -(0.8 + 0.1 * rng.random((1, 128, 2))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(1, 128, 4)).astype(np.float32) for _ in range(2))
    jy, _ = jm2.ssd_chunked(*map(jnp.asarray, (xdt, dA, Bm, Cm)), 128)
    jg = jax.grad(lambda d: jnp.sum(jm2.ssd_chunked(jnp.asarray(xdt), d, jnp.asarray(Bm),
                                                    jnp.asarray(Cm), 128)[0]))(jnp.asarray(dA))
    assert np.isnan(np.asarray(jg)).any()  # the reference's fault at this shape
    ins = [torch.tensor(a, requires_grad=True) for a in (xdt, dA, Bm, Cm)]
    y, _ = mamba2.ssd_chunked(*ins, 128)
    # the forward at the reference's SSD tolerance (tests/test_kernels.py:
    # 2e-4): 128-term sums in another order
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=2e-4, atol=2e-4)
    grads = torch.autograd.grad(y.sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_raw_kernel_wrappers_raise_under_grad():
    """A raw wrapper's output has no grad_fn: under grad it must refuse
    rather than drop the gradient."""
    q = torch.zeros((1, 2, 64, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        kflash.flash_attention(q, q.detach(), q.detach())
    x = torch.zeros((1, 16, 2, 4), requires_grad=True)
    dA, Bm = torch.zeros((1, 16, 2)), torch.zeros((1, 16, 3))
    with pytest.raises(RuntimeError, match="forward-only"):
        kssd.ssd_chunk_scan(x, dA, Bm, Bm, chunk=8)
    with pytest.raises(RuntimeError, match="forward-only"):
        kops.ssd_full(x, dA, Bm, Bm, chunk=8)
    with torch.no_grad():  # the serving path: no grad mode, no raise
        kflash.flash_attention(q, q, q)
        kops.ssd_full(x, dA, Bm, Bm, chunk=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_forward_runs_twice_per_layer_per_step(arch, monkeypatch):
    """With every layer checkpointed, the backward recomputes the layer's
    forward, the kernel's with it: a local step calls the K9 / K10 wrapper
    2 x n_layers times (``chip_smoke.py`` asserts the same count of CUDA
    launches on the card)."""
    target = (kops._flash, "flash_attention") if arch == "qwen3-1.7b" else (kops._ssd, "ssd_chunk_scan")
    calls = []
    real = getattr(*target)
    monkeypatch.setattr(*target, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, tcfg = cfgs(arch)
    fed = rounds.FedConfig(n_clients=2, local_steps=1, aggregation="eq6", topn=1,
                           client_axis="data", data_axis=None)
    state = rounds.make_state(tcfg, fed, sgd(1e-2), device="cpu")
    fr = rounds.build_fed_round(tcfg, fed, sgd(1e-2))
    batch = {"tokens": torch.from_numpy(tokens(tcfg, 2, SEQ[arch]).reshape(2, 1, 1, -1))}
    fr(state, batch, rounds.uniform_weights(2))
    assert len(calls) == 2 * tcfg.n_layers * fed.local_steps * fed.n_clients
    calls.clear()
    with torch.no_grad():  # serving: once per layer
        T.trunk(tcfg, params.map_tree(lambda x: x[0], rounds.unpacked_params(tcfg, fed, state)),
                torch.zeros((1, SEQ[arch], tcfg.d_model)))
    assert len(calls) == tcfg.n_layers


# ------------------------------ launchers and F1/F2 --------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_an_lm_on_cpu(arch, capsys):
    summary = train.main(["--task", "lm", "--arch", arch, "--device", "cpu", "--rounds", "2",
                          "--clients", "2", "--batch", "2", "--seq", "16",
                          "--participation", "masked"])
    assert set(summary) >= {"final_loss", "rounds", "participation", "mean_participants"}
    assert summary["rounds"] == 2 and np.isfinite(summary["final_loss"])
    assert summary["device"] == "cpu"
    assert '"final_loss"' in capsys.readouterr().out.splitlines()[-1]


def test_launcher_auto_task_and_store(tmp_path):
    args = train.build_parser().parse_args(["--arch", "mamba2-1.3b", "--device", "cpu", "--rounds",
                                            "1", "--clients", "2", "--seq", "16", "--store",
                                            str(tmp_path), "--partition", "dirichlet"])
    assert train.resolve_task(args) == "lm"
    run = train.train_lm(args, log=lambda m: None)
    assert run.summary["stored_rounds"] == [0] and run.slot is None
    stored = run.server.store.get_model("mamba2-1.3b", 0)
    glob = run.server.global_params()
    for path, x in params.flatten_with_paths(glob):
        assert np.array_equal(stored[path], x.numpy())
    assert train.resolve_task(train.build_parser().parse_args([])) == "detection"
    with pytest.raises(ValueError, match="--arch"):
        train.train_lm(train.build_parser().parse_args(["--task", "lm", "--device", "cpu"]))


def test_f2_serve_defaults_to_qwen3():
    assert serve.build_parser().parse_args([]).arch == "qwen3-1.7b"


def test_f1_conv_cache_owns_its_storage():
    """The prefill's conv tail is a (B, k-1, C) copy, not a view keeping the
    whole (B, S, C) pre-conv buffer alive; the outputs are unchanged."""
    _, tcfg = cfgs("mamba2-1.3b", impl=False)
    _, tp = weights(cfgs("mamba2-1.3b")[0])
    p = params.map_tree(lambda w: w[0], tp["layers"])["ssm"]
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 40, tcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        out, st = mamba2.mamba2_block(p, x, tcfg, return_state=True)
        plain = mamba2.mamba2_block(p, x, tcfg)
    di, _, n = mamba2.dims(tcfg)
    Cw = di + 2 * n
    assert st["conv"].shape == (2, tcfg.ssm_conv - 1, Cw)
    assert st["conv"].untyped_storage().nbytes() == 2 * (tcfg.ssm_conv - 1) * Cw * 4
    assert torch.equal(out, plain)
    # the tail holds the last k-1 pre-conv positions, bit for bit
    pre = torch.cat([torch.einsum("bsd,de->bse", x, p["wx"]), torch.einsum("bsd,dn->bsn", x, p["wB"]),
                     torch.einsum("bsd,dn->bsn", x, p["wC"])], dim=-1)
    assert torch.equal(st["conv"], pre[:, -(tcfg.ssm_conv - 1):])


# ------------------------------ on the card ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_kernel_branch_grads_match_plain_branch_on_card(arch):
    """K9 / K10 forward under autograd on the card against the plain branch:
    loss rtol 1e-4, gradients rtol 5e-3 / atol 5e-4 (the reference's pins,
    tests/test_kernels.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    _, tcfg = cfgs(arch)
    _, rcfg = cfgs(arch, impl=False)
    _, tp = weights(cfgs(arch)[0])
    tp = convert.lm_params_from_reference(convert.lm_params_to_reference(tp), dev)
    toks = tokens(tcfg, 2, 128)

    def run(cfg):
        p = params.map_tree(lambda w: w.clone().requires_grad_(True), tp)
        loss, _ = T.loss_fn(cfg, p, {"tokens": torch.from_numpy(toks).to(dev)})
        return loss, torch.autograd.grad(loss, [w for _, w in params.flatten_with_paths(p)])

    kflash.flash_attention.launches = kssd.ssd_chunk_scan.launches = 0
    lk, gk = run(tcfg)
    assert kflash.flash_attention.launches + kssd.ssd_chunk_scan.launches == 2 * tcfg.n_layers
    lr, gr = run(rcfg)
    torch.testing.assert_close(lk, lr, rtol=1e-4, atol=0)
    for a, b in zip(gk, gr):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-4)

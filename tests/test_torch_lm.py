"""The port's LM serving path (``repro_torch.models`` and the LM branch of
``repro_torch.launch.serve``) held against the reference, on the CPU.

Both packages run the same weights: the reference's ``init_params`` draws
them and ``convert.lm_params_from_reference`` carries them over. The
configs are the reduced qwen3-1.7b (2 layers, d_model 256, GQA 4/2, head_dim
64) and mamba2-1.3b (2 layers, 16 heads of 32, state 16, chunk 8).
Prompts of 128 tokens take the kernel branches (reference ``"pallas"`` in
interpret mode against the port's ``"kernel"``, which runs the plain versions
on the CPU); prompts of 37 take the fallback branches. Tolerances are the
reference's own pins (tests/test_models.py): prefill logits rtol = atol =
5e-4, decode logits 5e-3; the observed gaps are printed with ``-s``.
Greedy tokens must be equal, with the reference's top-2 margin asserted
above twice the logit gap at every step; teacher-forced logits at 5e-3.
"""
import dataclasses
import json
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
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import serving as jserving
from repro.models import transformer as jT
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import convert, layers
from repro_torch.models import serving as S
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-1.7b", "mamba2-1.3b"]
PREFILL_TOL, DECODE_TOL = 5e-4, 5e-3
B = 2


def cfgs(arch, impl=True, **kw):
    """(reference cfg, port cfg), reduced; ``impl`` selects the kernel branches."""
    j = dataclasses.replace(jget_arch(arch).reduced(), **kw)
    t = dataclasses.replace(get_arch(arch).reduced(), **kw)
    if impl:
        j = dataclasses.replace(j, attention_impl="pallas", ssm_impl="pallas")
        t = dataclasses.replace(t, attention_impl="kernel", ssm_impl="kernel")
    return j, t


def weights(jcfg, seed=1):
    jp = jparams.init_params(jT.template(jcfg), jax.random.key(seed), jnp.float32)
    return jp, convert.lm_params_from_reference(jax.tree.map(np.asarray, jp))


def prompts(cfg, S_len, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S_len + 1)).astype(np.int32)


def gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def test_configs_copy_the_reference():
    for arch in ARCHS:
        j, t = jget_arch(arch), get_arch(arch)
        for f in dataclasses.fields(t):
            want = getattr(j, f.name)
            want = {"pallas": "kernel"}.get(want, want) if f.name.endswith("_impl") else want
            assert getattr(t, f.name) == want, (arch, f.name)
        assert t.resolved_head_dim == j.resolved_head_dim
        assert dataclasses.asdict(t.reduced()) == {
            k: ({"pallas": "kernel"}.get(v, v) if k.endswith("_impl") else v)
            for k, v in dataclasses.asdict(j.reduced()).items()}


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    np.testing.assert_allclose(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)
    pos = np.arange(5)
    jc, js = jlayers.rope_freqs(jnp.asarray(pos), 64, 500000.0)
    tc, ts = layers.rope_freqs(torch.from_numpy(pos), 64, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jc, js)), rtol=1e-6, atol=1e-6)
    wg, wu = (rng.standard_normal((64, 96)).astype(np.float32) * 0.1 for _ in range(2))
    wd = rng.standard_normal((96, 64)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd))).numpy(),
        np.asarray(jlayers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))),
        rtol=1e-5, atol=1e-5)


def test_template_matches_reference_and_later_families_raise():
    """Every family's template builds and matches the reference's (slice
    7c); the families past dense and ssm, which raised until slice 7d, now
    run the training trunk to finite hidden states of the input's shape
    (tests/test_torch_lm_families_train.py holds them to the reference)."""
    later = ("zamba2-2.7b", "granite-moe-1b-a400m", "gemma3-27b", "llava-next-34b", "hubert-xlarge")
    for arch in (*ARCHS, *later):
        j, t = cfgs(arch)
        jt = jax.tree_util.tree_flatten_with_path(jT.template(j))[0]
        flat = dict(convert.flatten_with_paths(T.template(t)))
        assert len(flat) == len(jt)
        for path, info in jt:
            key = "/".join(p.key for p in path)
            assert flat[key].shape == info.shape and flat[key].init == info.init, key
    for arch in later:
        t = get_arch(arch).reduced()
        p = convert.lm_params_from_reference(jax.tree.map(
            np.asarray, jparams.init_params(jT.template(cfgs(arch)[0]), jax.random.key(0),
                                            jnp.float32)))
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 16, t.d_model))
                             .astype(np.float32))
        hidden, aux = T.trunk(t, p, x)
        assert hidden.shape == x.shape and bool(torch.isfinite(hidden).all())
        assert (float(aux) > 0) == (t.family == "moe")


@pytest.mark.parametrize("S_len", [128, 37])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, S_len):
    jcfg, tcfg = cfgs(arch)
    jp, tp = weights(jcfg)
    toks = prompts(tcfg, S_len)
    jl, jc = jax.jit(lambda p, t: jserving.prefill(jcfg, p, {"tokens": t}, max_len=S_len + 4))(
        jp, jnp.asarray(toks[:, :S_len]))
    jd, _ = jax.jit(lambda p, c, t: jserving.decode_step(jcfg, p, c, t, jnp.int32(S_len)))(
        jp, jc, jnp.asarray(toks[:, S_len:]))
    kflash.flash_attention.launches = kssd.ssd_chunk_scan.launches = 0
    with torch.inference_mode():
        tl, tc = S.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S_len])}, max_len=S_len + 4)
        td, _ = S.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, S_len:]), S_len)
    assert kflash.flash_attention.launches == 0 and kssd.ssd_chunk_scan.launches == 0  # CPU
    assert tl.shape == (B, 1, T.padded_vocab(tcfg)) and td.shape == tl.shape
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and str(tc[k].dtype).endswith(str(jc[k].dtype)), k
    with torch.inference_mode():  # the full forward's last position is the prefill's logits
        hidden, _ = T.trunk(tcfg, tp, T.embed_inputs(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S_len])}))
        full_last = T.logits_fn(tcfg, tp, hidden)[:, -1]
    np.testing.assert_allclose(full_last.numpy(), tl[:, 0].numpy(), rtol=PREFILL_TOL, atol=PREFILL_TOL)
    print(f"{arch} S={S_len}: prefill gap {gap(tl, jl):.3e}, decode gap {gap(td, jd):.3e}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL, atol=PREFILL_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("S_len,window,impl", [(64, 16, False), (40, 16, False), (128, 16, True),
                                                (128, 0, False)])
def test_attention_block_paths_match_reference(S_len, window, impl):
    """The windowed (structural, masked-fallback, flash) paths and the plain
    causal path of ``attention_block`` with ``return_kv``, then one windowed
    decode step on the ring buffer, against the reference's. At S = 40 the
    port's ring holds the reference's keys rolled into ring order (fault F3:
    the reference's are in position order), and its decode step is held to
    ``attention_block`` over all S + 1 positions, which the reference's
    misses (``tests/test_torch_lm_families.py`` records both)."""
    jcfg, tcfg = cfgs("qwen3-1.7b", impl=impl, window=window)
    jp, tp = weights(jcfg, seed=7)
    jl, tl = jax.tree.map(lambda w: w[0], jp["layers"]["attn"]), T.index(tp["layers"], 0)["attn"]
    x = np.random.default_rng(S_len).standard_normal((B, S_len + 1, jcfg.d_model)).astype(np.float32)
    jout, (jk, jv) = jattn.attention_block(jl, jnp.asarray(x[:, :S_len]), jcfg, window=window,
                                           return_kv=True)
    tout, (tk, tv) = attn.attention_block(tl, torch.from_numpy(x[:, :S_len]), tcfg, window=window,
                                          return_kv=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=PREFILL_TOL, atol=PREFILL_TOL)
    shift = S_len % window if window and S_len > window else 0  # F3: 0 where the reference is right
    np.testing.assert_allclose(tk.numpy(), np.roll(np.asarray(jk), shift, axis=1), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.roll(np.asarray(jv), shift, axis=1), rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    if not window:
        return
    jd, jc = jattn.decode_attention(jl, jnp.asarray(x[:, S_len:]), {"k": jk, "v": jv}, jcfg,
                                    jnp.int32(S_len), window=window)
    td, tc = attn.decode_attention(tl, torch.from_numpy(x[:, S_len:]), {"k": tk.clone(), "v": tv.clone()},
                                   tcfg, S_len, window=window)
    if shift:
        oracle = attn.attention_block(tl, torch.from_numpy(x), tcfg, window=window)[:, -1:]
        np.testing.assert_allclose(td.numpy(), oracle.numpy(), rtol=PREFILL_TOL, atol=PREFILL_TOL)
        assert gap(jd, oracle) > 1e-2
        return
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DECODE_TOL, atol=DECODE_TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=PREFILL_TOL, atol=PREFILL_TOL)


def test_query_chunked_attention_matches_reference(monkeypatch):
    """Queries at or above the threshold run in chunks of 1024 against the
    full K/V: same result as the reference's chunked path and as one
    softmax over all queries (the threshold lowered to 2048 here)."""
    monkeypatch.setattr(jattn, "Q_CHUNK_THRESHOLD", 2048)
    monkeypatch.setattr(attn, "Q_CHUNK_THRESHOLD", 2048)
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 2048, h, 16)).astype(np.float32) for h in (2, 1, 1))
    for causal in (True, False):
        want = jattn.full_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = attn.full_attention(tq, tk, tv, causal=causal)
        whole = attn._sdpa(tq, tk, tv, torch.ones((1, 1, 1, 2048, 2048), dtype=torch.bool).tril()
                           if causal else torch.ones((1, 1, 1, 2048, 2048), dtype=torch.bool))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PREFILL_TOL, atol=PREFILL_TOL)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=PREFILL_TOL, atol=PREFILL_TOL)


def _reference_decode_unrolled(cfg, params, cache, tokens, pos):
    """The reference's ``decode_step`` for a dense model, its scan over
    layers written as a loop over its own ``_dense_decode_block``: with
    float32 weights and a bfloat16 config the hidden state turns float32
    after the first layer, which ``lax.scan`` refuses as a carry."""
    h = params["embed"][tokens].astype(jnp.bfloat16)
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda w: w[i], params["layers"])
        h, _, _ = jserving._dense_decode_block(cfg, lp, h, cache["k"][i], cache["v"][i],
                                                jnp.int32(pos), cfg.window)
    return jT.logits_fn(cfg, params, jlayers.rms_norm(h, params["final_norm"], cfg.norm_eps))


def test_bf16_cache_and_mixed_dtype_decode_match_reference():
    jcfg, tcfg = cfgs("qwen3-1.7b", dtype="bfloat16")
    jp, tp = weights(jcfg, seed=5)
    toks = prompts(tcfg, 128, seed=6)
    jl, jc = jserving.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :128])}, max_len=130)
    jd = _reference_decode_unrolled(jcfg, jp, jc, jnp.asarray(toks[:, 128:]), 128)
    with torch.inference_mode():
        tl, tc = S.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :128])}, max_len=130)
        assert tc["k"].dtype == torch.bfloat16 and tc["k"].shape == jc["k"].shape
        # the float32 k before the cast agrees at the prefill tolerance, so
        # the cached bfloat16 values are one rounding (2^-7 relative) apart
        np.testing.assert_allclose(tc["k"].float().numpy(), np.asarray(jc["k"], np.float32),
                                   rtol=2 ** -7, atol=PREFILL_TOL)
        td, _ = S.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, 128:]), 128)
    print(f"bf16 cache: prefill gap {gap(tl, jl):.3e}, decode gap {gap(td, jd):.3e}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL, atol=PREFILL_TOL)
    np.testing.assert_allclose(td.float().numpy(), np.asarray(jd, np.float32), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def _reference_trace(jcfg, jp, toks, n):
    """Greedy tokens and every step's logits from the reference."""
    Sq = toks.shape[1]
    prefill, step = jserve.decode_programs(jcfg, Sq + n)
    logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)})
    out, steps = [], [np.asarray(logits[:, -1])]
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(n):
        out.append(np.asarray(tok))
        logits, cache = step(jp, cache, tok, jnp.int32(Sq + i))
        steps.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, 1), steps


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_is_token_equal_to_reference(arch):
    jcfg, tcfg = cfgs(arch)
    jp, tp = weights(jcfg, seed=2)
    toks = prompts(tcfg, 128, seed=4)[:, :128]
    n = 6
    want, jsteps = _reference_trace(jcfg, jp, toks, n)
    got = serve.generate(tcfg, tp, torch.from_numpy(toks), n)
    # teacher forcing on the reference's tokens: every step's logits
    with torch.inference_mode():
        logits, cache = S.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, max_len=128 + n)
        tsteps = [logits[:, -1].numpy()]
        for i in range(n):
            logits, cache = S.decode_step(tcfg, tp, cache, torch.from_numpy(want[:, i:i + 1]), 128 + i)
            tsteps.append(logits[:, -1].numpy())
    gaps = [gap(a, b) for a, b in zip(tsteps, jsteps)]
    margins = [float(np.min(np.diff(np.sort(s, -1)[:, -2:], axis=-1))) for s in jsteps[:n]]
    print(f"{arch}: logit gaps {['%.2e' % g for g in gaps]}, top-2 margins "
          f"{['%.2e' % m for m in margins]}")
    for a, b in zip(tsteps, jsteps):
        np.testing.assert_allclose(a, b, rtol=DECODE_TOL, atol=DECODE_TOL)
    assert all(m > 2 * g for m, g in zip(margins, gaps))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_prints_the_reference_launchers_tokens(arch, capsys, monkeypatch):
    """Same reduced config, params (the reference launcher's ``key(0)``
    draw) and prompts (``default_rng(0)``): the generated tokens agree."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--new-tokens", "8"])
    jserve.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcfg = jget_arch(arch).reduced()
    jp = jparams.init_params(jT.template(jcfg), jax.random.key(0), jnp.float32)
    args = serve.build_parser().parse_args(["--arch", arch, "--new-tokens", "8", "--device", "cpu"])
    got = serve.serve_lm(get_arch(arch).reduced(), args, torch.device("cpu"),
                         params=convert.lm_params_from_reference(jax.tree.map(np.asarray, jp)))
    assert got["generated"] == want["generated"] and got["arch"] == want["arch"]
    assert got["device"] == "cpu"


def _run(args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_lm_path_on_cpu(arch):
    r = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
              "--prompt-len", "16", "--new-tokens", "4"])
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["arch"] == f"{arch}-reduced" and out["device"] == "cpu"
    assert len(out["generated"]) == 4 and out["tokens_per_s"] > 0


def test_sampling_draws_from_the_explicit_generator():
    _, tcfg = cfgs("mamba2-1.3b")
    _, tp = weights(cfgs("mamba2-1.3b")[0])
    toks = torch.from_numpy(prompts(tcfg, 16)[:, :16])
    draw = [serve.generate(tcfg, tp, toks, 5, temperature=1.0,
                           generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])


def test_lm_params_round_trip_is_bit_exact():
    jcfg, _ = cfgs("qwen3-1.7b")
    jp, tp = weights(jcfg)
    back = convert.lm_params_to_reference(tp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0], jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32), b.view(np.int32), err_msg=str(path))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_prefill_runs_the_kernels_and_matches_plain_on_card(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    _, tcfg = cfgs(arch)
    _, tp = weights(cfgs(arch)[0])
    tp = convert.lm_params_from_reference(convert.lm_params_to_reference(tp), dev)
    toks = torch.from_numpy(prompts(tcfg, 128)[:, :128]).to(dev)
    kflash.flash_attention.launches = kssd.ssd_chunk_scan.launches = 0
    with torch.inference_mode():
        kl, _ = S.prefill(tcfg, tp, {"tokens": toks})
        launches = kflash.flash_attention.launches + kssd.ssd_chunk_scan.launches
        rl, _ = S.prefill(dataclasses.replace(tcfg, attention_impl="ref", ssm_impl="ref"), tp,
                          {"tokens": toks})
    assert launches == tcfg.n_layers
    torch.testing.assert_close(kl, rl, rtol=PREFILL_TOL, atol=PREFILL_TOL)

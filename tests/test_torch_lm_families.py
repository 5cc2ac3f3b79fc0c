"""The port's serving path for every LM family (``repro_torch.models`` and
the LM branch of ``repro_torch.launch.serve``) held against the reference,
on the CPU: the GShard MoE (granite-moe-1b-a400m, gshard and sort), gemma3's
local/global groups and ring caches (8 layers, so a tail exists), the zamba2
hybrid, llava's image tokens (with a config of 6 q heads over 2 kv heads
padded to 4 a group, since ``reduced()`` zeroes the padding) and minitron's
untied head; the registries, configs and templates of all 11 archs; and the
windowed cache's slot order (F3).

Both packages run the same weights: the reference's ``init_params`` draws
them and ``convert.lm_params_from_reference`` carries them over. The port
runs its kernel branches (``"kernel"``: the plain versions of K9 and K10 on
the CPU) against the reference's jnp paths, at 128-token prefills, so both
of K9's windowed and global cases and K10 are held. The reference's jitted
prefill and decode come from its own ``launch/serve.py::decode_programs``,
cached per (config, length) and shared by every case here. Tolerances are
the reference's pins (tests/test_models.py): prefill logits and every cache
leaf rtol = atol = 5e-4, decode logits 5e-3; greedy tokens equal where the
reference's top-2 margin is above twice the logit gap; the observed gaps
print with ``-s``.
"""
import dataclasses
import functools
import json
import sys

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import params as jparams
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import convert
from repro_torch.models import serving as S
from repro_torch.models import transformer as T
from repro_torch.models.params import flatten_with_paths

PREFILL_TOL, DECODE_TOL = 5e-4, 5e-3
B, NEW = 2, 4
ALL_ARCHS = [c.name for c in jconfigs.ASSIGNED]
# (case id, arch, config overrides): the families this slice serves
FAMILIES = [
    ("moe-gshard", "granite-moe-1b-a400m", {}),
    ("moe-sort", "granite-moe-1b-a400m", {"moe_impl": "sort"}),
    ("gemma3", "gemma3-27b", {"n_layers": 8}),
    ("hybrid", "zamba2-2.7b", {}),
    ("vlm-padded", "llava-next-34b", {"n_heads": 6, "n_kv_heads": 2, "q_group_pad": 4}),
    ("untied", "minitron-8b", {}),
]


def cfgs(arch, **kw):
    """(reference cfg on its jnp paths, port cfg on its kernel branches), reduced."""
    j = dataclasses.replace(jconfigs.get_arch(arch).reduced(), **kw)
    t = dataclasses.replace(configs.get_arch(arch).reduced(), **kw)
    return j, dataclasses.replace(t, attention_impl="kernel", ssm_impl="kernel")


@functools.lru_cache(maxsize=None)
def weights(jcfg, seed=1):
    """(reference params, port params): drawn once per config (in one
    jitted program) and shared."""
    tpl = jT.template(jcfg)
    jp = jax.jit(lambda key: jparams.init_params(tpl, key, jnp.float32))(jax.random.key(seed))
    return jp, convert.lm_params_from_reference(jax.tree.map(np.asarray, jp))


def inputs(cfg, seed=3):
    """A prefill of 128 positions (images first for a vlm) and NEW more
    tokens: (tokens (B, Sq + NEW) int32, images or None)."""
    rng = np.random.default_rng(seed)
    ni = cfg.n_image_tokens if cfg.modality == "vlm" else 0
    toks = rng.integers(0, cfg.vocab_size, (B, 128 - ni + NEW)).astype(np.int32)
    images = (rng.standard_normal((B, ni, cfg.d_model)) * 0.1).astype(np.float32) if ni else None
    return toks, images


def batches(toks, images, Sq):
    jb, tb = {"tokens": jnp.asarray(toks[:, :Sq])}, {"tokens": torch.from_numpy(toks[:, :Sq])}
    if images is not None:
        jb["images"], tb["images"] = jnp.asarray(images), torch.from_numpy(images)
    return jb, tb


def gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))



# ----------------------------- configs and templates --------------------------

def test_registries_name_the_same_archs():
    assert [c.name for c in configs.ASSIGNED] == ALL_ARCHS and len(ALL_ARCHS) == 10
    assert sorted(configs.REGISTRY) == sorted(jconfigs.REGISTRY) and len(configs.REGISTRY) == 11
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_and_reduced_copy_the_reference(arch):
    """Every field, and ``reduced()`` field for field (the port's impl
    names ``"kernel"`` where the reference says ``"pallas"``)."""
    j, t = jconfigs.get_arch(arch), configs.get_arch(arch)
    rename = lambda k, v: {"pallas": "kernel"}.get(v, v) if k.endswith("_impl") else v
    assert dataclasses.asdict(t) == {k: rename(k, v) for k, v in dataclasses.asdict(j).items()}
    assert dataclasses.asdict(t.reduced()) == {k: rename(k, v)
                                               for k, v in dataclasses.asdict(j.reduced()).items()}
    assert (t.resolved_head_dim, t.has_decode, t.is_encoder_only) == (
        j.resolved_head_dim, j.has_decode, j.is_encoder_only)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_template_matches_reference(arch):
    """Paths, shapes, logical axes and inits of the reduced template."""
    j, t = jconfigs.get_arch(arch).reduced(), configs.get_arch(arch).reduced()
    want = jax.tree_util.tree_flatten_with_path(jT.template(j), is_leaf=jparams.is_info)[0]
    got = dict(flatten_with_paths(T.template(t)))
    assert len(got) == len(want)
    for path, info in want:
        g = got["/".join(p.key for p in path)]
        assert (g.shape, g.axes, g.init, g.scale) == (info.shape, info.axes, info.init, info.scale)


@pytest.mark.parametrize("case,arch,kw", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_lm_params_round_trip_is_bit_exact(case, arch, kw):
    jcfg, _ = cfgs(arch, **kw)
    jp, tp = weights(jcfg)
    back = convert.lm_params_to_reference(tp)
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(flatten_with_paths(back))
    assert len(got) == len(want)
    for path, a in want:
        b = got["/".join(p.key for p in path)]
        np.testing.assert_array_equal(np.asarray(a).view(np.int32), b.view(np.int32), err_msg=str(path))


# ----------------------------- prefill, decode, generate ----------------------

@pytest.mark.parametrize("case,arch,kw", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_prefill_caches_and_decode_match_reference(case, arch, kw):
    jcfg, tcfg = cfgs(arch, **kw)
    jp, tp = weights(jcfg)
    toks, images = inputs(tcfg)
    Sq = toks.shape[1] - NEW
    ni = 128 - Sq
    prefill, step = jserve.decode_programs(jcfg, ni + Sq + NEW)
    jb, tb = batches(toks, images, Sq)
    jl, jc = prefill(jp, jb)
    jd, jc = step(jp, jc, jnp.asarray(toks[:, Sq:Sq + 1]), jnp.int32(ni + Sq))
    kflash.flash_attention.launches = kssd.ssd_chunk_scan.launches = 0
    with torch.inference_mode():
        tl, tc = S.prefill(tcfg, tp, tb, max_len=ni + Sq + NEW)
        pre = {p: a.clone() for p, a in flatten_with_paths(tc)}
        td, tc = S.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, Sq:Sq + 1]), ni + Sq)
        # the prefill's cache against a fresh prefill's through the reference
        _, jc0 = prefill(jp, jb)
    assert kflash.flash_attention.launches == 0 and kssd.ssd_chunk_scan.launches == 0  # CPU
    assert tl.shape == (B, 1, T.padded_vocab(tcfg)) and td.shape == tl.shape
    want0 = dict(flatten_with_paths(jax.tree.map(np.asarray, jc0)))
    want1 = dict(flatten_with_paths(jax.tree.map(np.asarray, jc)))
    assert sorted(pre) == sorted(want0)
    cache_gap = 0.0
    for path, a in pre.items():
        assert tuple(a.shape) == want0[path].shape and str(a.dtype).endswith(str(want0[path].dtype)), path
        np.testing.assert_allclose(a.numpy(), want0[path], rtol=PREFILL_TOL, atol=PREFILL_TOL,
                                   err_msg=path)
        cache_gap = max(cache_gap, gap(a, want0[path]))
    for path, a in flatten_with_paths(tc):  # after one decode step, in place
        np.testing.assert_allclose(a.numpy(), want1[path], rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=path)
    print(f"{case}: prefill gap {gap(tl, jl):.3e}, cache gap {cache_gap:.3e}, decode gap "
          f"{gap(td, jd):.3e}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=PREFILL_TOL, atol=PREFILL_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("case,arch,kw", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_generate_is_token_equal_to_reference(case, arch, kw):
    """Greedy tokens from the reference's ``generate`` and the port's, and
    every step's logits teacher-forced on the reference's tokens; the
    port's decode also against its own full forward over the sequence,
    except under MoE: GShard's capacity depends on the routing group, so a
    forward over S + n tokens routes (and drops) differently from a prefill
    of S and one-token steps, in the reference as in the port."""
    jcfg, tcfg = cfgs(arch, **kw)
    jp, tp = weights(jcfg)
    toks, images = inputs(tcfg, seed=4)
    Sq = toks.shape[1] - NEW
    ni = 128 - Sq
    jimg = None if images is None else jnp.asarray(images)
    want = np.asarray(jserve.generate(jcfg, jp, jnp.asarray(toks[:, :Sq]), NEW, jimg))
    timg = None if images is None else torch.from_numpy(images)
    got = serve.generate(tcfg, tp, torch.from_numpy(toks[:, :Sq]), NEW, images=timg)
    prefill, step = jserve.decode_programs(jcfg, ni + Sq + NEW)
    jb, tb = batches(toks, images, Sq)
    logits, cache = prefill(jp, jb)
    jsteps = [np.asarray(logits[:, -1])]
    with torch.inference_mode():
        tl, tc = S.prefill(tcfg, tp, tb, max_len=ni + Sq + NEW)
        tsteps = [tl[:, -1].numpy()]
        for i in range(NEW):
            tok = want[:, i:i + 1]
            logits, cache = step(jp, cache, jnp.asarray(tok), jnp.int32(ni + Sq + i))
            jsteps.append(np.asarray(logits[:, -1]))
            tl, tc = S.decode_step(tcfg, tp, tc, torch.from_numpy(tok), ni + Sq + i)
            tsteps.append(tl[:, -1].numpy())
        fb = dict(tb, tokens=torch.cat([tb["tokens"], torch.from_numpy(want)], 1))
        hidden, _ = S.prefill_hidden(tcfg, tp, fb)
        full = T.logits_fn(tcfg, tp, hidden[:, ni + Sq - 1:ni + Sq + NEW]).numpy()
    gaps = [gap(a, b) for a, b in zip(tsteps, jsteps)]
    full_gap = max(gap(full[:, i], tsteps[i]) for i in range(NEW + 1))
    margins = [float(np.min(np.diff(np.sort(s, -1)[:, -2:], axis=-1))) for s in jsteps[:NEW]]
    print(f"{case}: logit gaps {['%.2e' % g for g in gaps]}, top-2 margins "
          f"{['%.2e' % m for m in margins]}, decode against the full forward {full_gap:.2e}")
    for a, b in zip(tsteps, jsteps):
        np.testing.assert_allclose(a, b, rtol=DECODE_TOL, atol=DECODE_TOL)
    if tcfg.family != "moe":
        for i in range(NEW + 1):
            np.testing.assert_allclose(tsteps[i], full[:, i], rtol=DECODE_TOL, atol=DECODE_TOL)
    assert all(m > 2 * g for m, g in zip(margins, gaps))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------- F3: the ring's slot order ----------------------

@pytest.mark.parametrize("S_len", [32, 12, 16, 40])
def test_f3_windowed_cache_slot_order(S_len):
    """gemma3's local attention (W = 16): prefill S tokens with return_kv,
    decode token S on the ring. The oracle is ``attention_block`` over all
    S + 1 tokens. Where S % W == 0 or S <= W the reference's cache is in
    ring order and the port equals it; at S = 40 the reference stores the
    window in position order, its decode evicts an in-window key, and it
    misses the oracle by more than 1e-2 while the port holds 5e-4."""
    jcfg, tcfg = cfgs("gemma3-27b", n_layers=8)
    W = tcfg.window
    jp, tp = weights(jcfg)
    jl = jax.tree.map(lambda w: w[0, 0], jp["groups"]["attn"])
    tl = T.index(T.index(tp["groups"], 0), 0)["attn"]
    x = np.random.default_rng(S_len).standard_normal((B, S_len + 1, jcfg.d_model)).astype(np.float32)
    oracle = attn.attention_block(tl, torch.from_numpy(x), tcfg, window=W)[:, -1:].numpy()
    _, (tk, tv) = attn.attention_block(tl, torch.from_numpy(x[:, :S_len]), tcfg, window=W,
                                       return_kv=True)
    _, (jk, jv) = jax.jit(lambda p, h: jattn.attention_block(p, h, jcfg, window=W, return_kv=True))(
        jl, jnp.asarray(x[:, :S_len]))
    td, _ = attn.decode_attention(tl, torch.from_numpy(x[:, S_len:]), {"k": tk.clone(), "v": tv.clone()},
                                  tcfg, S_len, window=W)
    jd, _ = jax.jit(lambda p, h, c: jattn.decode_attention(p, h, c, jcfg, jnp.int32(S_len), window=W))(
        jl, jnp.asarray(x[:, S_len:]), {"k": jk, "v": jv})
    port_gap, ref_gap = gap(td, oracle), gap(jd, oracle)
    print(f"F3 S={S_len} W={W}: port decode against the full-sequence oracle {port_gap:.3e}, "
          f"the reference's {ref_gap:.3e}")
    np.testing.assert_allclose(td.numpy(), oracle, rtol=PREFILL_TOL, atol=PREFILL_TOL)
    if S_len % W == 0 or S_len <= W:
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=PREFILL_TOL, atol=PREFILL_TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=PREFILL_TOL, atol=PREFILL_TOL)
    else:
        # the same keys, rolled from position order into ring order
        np.testing.assert_allclose(tk.numpy(), np.roll(np.asarray(jk), S_len % W, axis=1),
                                   rtol=PREFILL_TOL, atol=PREFILL_TOL)
        assert ref_gap > 1e-2


def test_f3_gemma3_decode_matches_its_full_forward_past_the_window():
    """The whole reduced gemma3 (8 layers, W = 16) at S = 40: the port's
    decode step equals its own full forward over S + 1 tokens at the decode
    tolerance; the reference's decode misses it."""
    jcfg, tcfg = cfgs("gemma3-27b", n_layers=8)
    jp, tp = weights(jcfg)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (B, 41)).astype(np.int32)
    prefill, step = jserve.decode_programs(jcfg, 44)
    _, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, :40])})
    jd, _ = step(jp, jc, jnp.asarray(toks[:, 40:]), jnp.int32(40))
    with torch.inference_mode():
        _, tc = S.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :40])}, max_len=44)
        td, _ = S.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, 40:]), 40)
        hidden, _ = S.prefill_hidden(tcfg, tp, {"tokens": torch.from_numpy(toks)})
        full = T.logits_fn(tcfg, tp, hidden[:, -1:])
    print(f"F3 gemma3 S=40: port decode against its full forward {gap(td, full):.3e}, the "
          f"reference's decode {gap(jd, full):.3e}")
    np.testing.assert_allclose(td.numpy(), full.numpy(), rtol=DECODE_TOL, atol=DECODE_TOL)
    assert gap(jd, full) > 1e-2


# ----------------------------- the launcher -----------------------------------

@pytest.mark.parametrize("arch", ["llava-next-34b", "zamba2-2.7b", "granite-moe-1b-a400m"])
def test_launcher_prints_the_reference_launchers_tokens(arch, capsys, monkeypatch):
    """Same reduced config, params (the reference launcher's ``key(0)``
    draw), prompts and (llava) image embeddings from ``default_rng(0)``:
    the generated tokens agree."""
    flags = ["--arch", arch, "--new-tokens", "6", "--prompt-len", "16"]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jserve.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcfg = jconfigs.get_arch(arch).reduced()
    jp = jparams.init_params(jT.template(jcfg), jax.random.key(0), jnp.float32)
    args = serve.build_parser().parse_args([*flags, "--device", "cpu"])
    got = serve.serve_lm(configs.get_arch(arch).reduced(), args, torch.device("cpu"),
                         params=convert.lm_params_from_reference(jax.tree.map(np.asarray, jp)))
    assert got["generated"] == want["generated"] and got["arch"] == want["arch"]


def test_launcher_refuses_the_encoder_only_arch_as_the_reference_does(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "hubert-xlarge"])
    with pytest.raises(SystemExit) as want:
        jserve.main()
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    assert str(got.value) == str(want.value) and "encoder-only" in str(got.value)


# ----------------------------- on the card ------------------------------------

# K9 and K10 at this slice's new shapes, scaled down where the card's full
# shape would be slow to hold here: (B, H, Hkv, S, hd, window) and (B, S, H,
# P, N, chunk); ``chip_smoke.py`` phase 8 holds the full shapes
FLASH_NEW = [(1, 32, 32, 1024, 80, 0), (1, 32, 16, 1536, 128, 1024), (1, 64, 8, 3968, 128, 0)]
SSD_NEW = [(1, 1024, 80, 64, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_NEW)
def test_cuda_flash_attention_at_the_families_shapes(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import ops

    Bc, H, Hkv, Sc, hd, window = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((Bc, H, Sc, hd), generator=g, device="cuda")
    k, v = (torch.randn((Bc, Hkv, Sc, hd), generator=g, device="cuda") for _ in range(2))
    kern = ops.flash_attention(q, k, v, causal=True, window=window)
    plain = ops.flash_attention(q, k, v, causal=True, window=window, impl="ref")
    torch.testing.assert_close(kern, plain, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_NEW)
def test_cuda_ssd_scan_at_the_hybrids_shape(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import ops

    Bc, Sc, H, P, N, Q = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    xdt = torch.randn((Bc, Sc, H, P), generator=g, device="cuda") * 0.1
    dA = -(torch.randn((Bc, Sc, H), generator=g, device="cuda") * 0.1).abs()
    Bm, Cm = (torch.randn((Bc, Sc, N), generator=g, device="cuda") for _ in range(2))
    for a, b in zip(ops.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=Q),
                    ops.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=Q, impl="ref")):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)

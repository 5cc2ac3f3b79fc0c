"""K11, the per-leaf masked FedAvg (``repro_torch.kernels.fedavg`` and
``kernels.ops.fedavg_tree``), held against the reference's Pallas kernel
(interpret mode, as its own tests run it) and its jnp oracle, on the CPU.

Inputs are drawn with NumPy from fixed seeds and handed to both packages.
Tolerance: the reference's own pin for ``fedavg_tree``
(``tests/test_kernels.py:84-93``), rtol 1e-5 / atol 1e-6, for float32 and
bfloat16 leaves alike (a bfloat16 output rounds once from the same float32
mean; the two packages agreed bit for bit on every case here when this was
written, tighter than ``test_fedavg_kernel``'s 2e-2). The plain version against
the ordered chain it documents, and the wrapper against the plain version,
are bitwise. Card-only cases carry the ``cuda`` marker.
"""
import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import fedavg as jfedavg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fedavg, ops, ref
from repro_torch.models.params import flatten_with_paths

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(C, N, seed, zero_mask=False, bf16=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.dirichlet([1.0] * C).astype(np.float32)
    m = rng.integers(0, 2, C).astype(np.float32)
    if zero_mask:
        m[:] = 0.0
    elif m.sum() == 0:
        m[0] = 1.0
    jx = jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)
    tx = torch.tensor(x).to(torch.bfloat16) if bf16 else torch.tensor(x)
    return (jx, jnp.asarray(w), jnp.asarray(m)), (tx, torch.tensor(w), torch.tensor(m))


@pytest.mark.parametrize("C,N", [(2, 128), (4, 3000), (8, 1024), (3, 17), (1, 1), (3, 1025)])
@pytest.mark.parametrize("bf16", [False, True])
def test_fedavg_masked_mean_matches_reference_kernel(C, N, bf16):
    (jx, jw, jm), (tx, tw, tm) = _case(C, N, seed=C * 7919 + N, bf16=bf16)
    want = jfedavg.fedavg_masked_mean(jx, jw, jm, block_n=256)
    got = fedavg.fedavg_masked_mean(tx, tw, tm)
    assert got.dtype == tx.dtype and got.shape == (N,)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)
    if not bf16:  # and the reference's jnp oracle
        np.testing.assert_allclose(got.numpy(), np.asarray(jref.fedavg_masked_mean(jx, jw, jm)),
                                   **TOL)


def test_all_zero_mask_gives_zero():
    """den clamps to 1e-12 and the numerator is 0: every output is 0, as in
    the reference."""
    (jx, jw, jm), (tx, tw, tm) = _case(3, 1030, seed=4, zero_mask=True)
    got = fedavg.fedavg_masked_mean(tx, tw, tm)
    assert torch.equal(got, torch.zeros_like(got))
    assert np.array_equal(np.asarray(jfedavg.fedavg_masked_mean(jx, jw, jm)), got.numpy())
    wm, den = fedavg.weighted_mask(tw, tm)
    assert den.dim() == 0 and den.item() == np.float32(1e-12)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_version_is_the_ordered_chain(bf16):
    """acc = 0 + x0 wm0, then acc = acc + xc wmc, one true division, one cast:
    what csrc/fedavg.cu computes, written out in NumPy float32."""
    _, (tx, tw, tm) = _case(5, 2049, seed=11, bf16=bf16)
    wm, den = fedavg.weighted_mask(tw, tm)
    got = ref.fedavg_masked_mean(tx, wm, den)
    xs, w = tx.float().numpy(), wm.numpy()
    acc = np.zeros(2049, np.float32)
    for c in range(5):
        acc = (acc + (xs[c] * w[c]).astype(np.float32)).astype(np.float32)
    want = torch.tensor(acc / np.float32(den.item())).to(tx.dtype)
    assert torch.equal(got, want)
    assert torch.equal(ops.fedavg_masked_mean(tx, tw, tm), ops.fedavg_masked_mean(tx, tw, tm, impl="ref"))


def test_wrapper_validates_its_operands():
    x = torch.zeros((3, 10))
    with pytest.raises(ValueError, match="stacked"):
        fedavg.fedavg_masked_mean(torch.zeros(10), torch.ones(3), torch.ones(3))
    with pytest.raises(ValueError, match="mask"):
        fedavg.fedavg_masked_mean(x, torch.ones(3), torch.ones(2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fedavg.fedavg_masked_mean(x.double(), torch.ones(3), torch.ones(3))
    with pytest.raises(ValueError, match="impl"):
        ops.fedavg_tree({"a": x}, torch.ones(3), {"a": torch.ones(3)}, impl="pallas")


def _tree_case(bf16=False):
    """The reference test's tree (``tests/test_kernels.py:84``) plus ragged
    leaves, a zero mask and nesting; NumPy inputs for both packages."""
    rng = np.random.default_rng(42)
    shapes = {"a": (3, 4, 5), "b": {"c": (3, 7), "d": (3, 1025)}, "e": (3, 2, 3, 171)}
    masks = {"a": [1.0, 1.0, 1.0], "b": {"c": [1.0, 1.0, 0.0], "d": [0.0, 0.0, 0.0]},
             "e": [0.0, 1.0, 1.0]}

    def build(f, node):
        return {k: build(f, v) for k, v in node.items()} if isinstance(node, dict) else f(node)

    x = build(lambda s: rng.normal(size=s).astype(np.float32), shapes)
    m = build(lambda v: np.asarray(v, np.float32), masks)
    w = np.asarray([0.5, 0.25, 0.25], np.float32)
    jt = lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
    tt = lambda a: torch.tensor(a).to(torch.bfloat16 if bf16 else torch.float32)
    return ((build(jt, x), jnp.asarray(w), build(jnp.asarray, m)),
            (build(tt, x), torch.tensor(w), build(torch.tensor, m)))


@pytest.mark.parametrize("bf16", [False, True])
def test_fedavg_tree_matches_reference(bf16):
    (jx, jw, jm), (tx, tw, tm) = _tree_case(bf16)
    want = dict(flatten_with_paths(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                jops.fedavg_tree(jx, jw, jm))))
    got = ops.fedavg_tree(tx, tw, tm)
    leaves = list(flatten_with_paths(got))
    assert [p for p, _ in leaves] == sorted(want) == ["a", "b/c", "b/d", "e"]
    for path, x in leaves:
        src = dict(flatten_with_paths(tx))[path]
        assert x.shape == src.shape[1:] and x.dtype == src.dtype
        np.testing.assert_allclose(x.float().numpy(), want[path], **TOL, err_msg=path)
    assert torch.equal(got["b"]["d"], torch.zeros_like(got["b"]["d"]))  # nobody uploaded


def test_fedavg_tree_launches_once_per_leaf(monkeypatch):
    """One K11 call per leaf, each with that leaf's own mask."""
    calls = []
    real = fedavg.fedavg_masked_mean
    monkeypatch.setattr(fedavg, "fedavg_masked_mean",
                        lambda x, w, m: calls.append((tuple(x.shape), m.tolist())) or real(x, w, m))
    _, (tx, tw, tm) = _tree_case()
    ops.fedavg_tree(tx, tw, tm)
    assert calls == [((3, 20), [1.0, 1.0, 1.0]), ((3, 7), [1.0, 1.0, 0.0]),
                     ((3, 1025), [0.0, 0.0, 0.0]), ((3, 1026), [0.0, 1.0, 1.0])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_is_bitwise_its_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for C, N in ((1, 1), (2, 1023), (3, 1025), (8, 70001)):
        x = torch.randn((C, N), generator=g, device=dev).to(dtype)
        w = torch.rand(C, generator=g, device=dev)
        for m in (torch.ones(C, device=dev), (torch.arange(C, device=dev) % 2).float(),
                  torch.zeros(C, device=dev)):
            before = fedavg.fedavg_masked_mean.launches
            got = ops.fedavg_masked_mean(x, w, m)
            assert fedavg.fedavg_masked_mean.launches == before + 1
            want = ops.fedavg_masked_mean(x, w, m, impl="ref")
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                                                else torch.int32),
                                                       want.view(torch.int16 if dtype == torch.bfloat16
                                                                 else torch.int32))

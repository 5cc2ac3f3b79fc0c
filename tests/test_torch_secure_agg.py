"""The port's tree-level secure aggregation (``repro_torch.core.secure_agg``)
held against the reference's ``repro/core/secure_agg.py``.

``pair_seed`` is integer arithmetic in both packages: bitwise, and equal to
the reference's NumPy twin ``kernels/ref.pair_seed_np``. The masks are
drawn by ``torch.randn`` from a generator seeded with ``pair_seed``, where
the reference draws from ``jax.random``'s threefry stream, which torch
cannot reproduce: the masks differ between the packages, so what is held
is what the construction promises, on the same updates. The masked mean
equals the plain mean at the reference's own rtol/atol 1e-3
(``tests/test_secure_agg.py``), and so does the reference's
``secure_fedavg``; one masked upload hides its update (mean |diff| over 10,
|corr| under 0.9, the reference's bounds).
"""
import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch
from _hyp import given, settings, st

import jax
import jax.numpy as jnp

from repro.core import secure_agg as jsa
from repro.kernels import ref as jref
from repro_torch.core import secure_agg as sa
from repro_torch.models.params import flatten_with_paths


def _updates(n, shape=(16,), seed=0):
    """The reference test's updates, as NumPy trees."""
    rng = np.random.default_rng(seed)
    return [
        {"w": rng.normal(size=shape).astype(np.float32),
         "b": {"x": rng.normal(size=(4,)).astype(np.float32)}}
        for _ in range(n)
    ]


def _torch(tree, device="cpu"):
    return {"w": torch.tensor(tree["w"], device=device), "b": {"x": torch.tensor(tree["b"]["x"], device=device)}}


def _plain_mean(ups):
    n = len(ups)
    return {"w": sum(u["w"] for u in ups) / n, "b": {"x": sum(u["b"]["x"] for u in ups) / n}}


def _assert_tree_close(got, want, tol=1e-3):
    want = dict(flatten_with_paths(want))
    got = dict(flatten_with_paths(got))
    assert list(got) == list(want) == ["b/x", "w"]
    for path, x in got.items():
        np.testing.assert_allclose(np.asarray(x.cpu() if torch.is_tensor(x) else x), want[path],
                                   rtol=tol, atol=tol, err_msg=path)


def test_pair_seed_bitwise_the_reference_and_its_numpy_twin():
    big = [0, 1, 7, 2**31 - 1, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 3]
    for i, j in [(0, 1), (1, 3), (5, 2), (1023, 4), (2**32 + 1, 2)]:
        for r in big:
            for session in (0, 1, 2**32 + 9):
                got = sa.pair_seed(i, j, r, session)
                assert got == jsa.pair_seed(i, j, r, session) == jref.pair_seed_np(i, j, r, session)
                assert 0 <= got < 2**31
    for h in (0, 1, 0x9E3779B9, 2**32 - 1, 2**40 + 17):
        assert sa._mix32(h) == jsa._mix32(h)


def test_pair_seed_symmetric_and_round_dependent():
    for i, j, r in [(1, 3, 7), (0, 5, 0), (4, 2, 2**33)]:
        assert sa.pair_seed(i, j, r) == sa.pair_seed(j, i, r)
    assert sa.pair_seed(1, 3, 7) != sa.pair_seed(1, 3, 8)
    assert sa.pair_seed(1, 3, 7, session=1) != sa.pair_seed(1, 3, 7, session=2)


@given(st.integers(2, 6), st.integers(0, 5))
@settings(max_examples=12, deadline=None)
def test_masks_cancel_exactly(n, round_idx):
    ups = _updates(n, seed=round_idx)
    secure = sa.secure_fedavg([_torch(u) for u in ups], round_idx, scale=100.0)
    _assert_tree_close(secure, _plain_mean(ups))


def test_secure_fedavg_equals_the_references_on_the_same_updates():
    ups = _updates(4, shape=(64, 3), seed=11)
    for round_idx, session in [(0, 0), (3, 7)]:
        ours = sa.secure_fedavg([_torch(u) for u in ups], round_idx, session=session)
        ref = jsa.secure_fedavg([jax.tree.map(jnp.asarray, u) for u in ups], round_idx,
                                session=session)
        _assert_tree_close(ours, jax.tree.map(np.asarray, ref))
        _assert_tree_close(ours, _plain_mean(ups))
    # the plain sum of masked uploads is the sum of the updates: masks cancel
    masked = [sa.mask_update(_torch(u), i, 4, 2, scale=100.0) for i, u in enumerate(ups)]
    total = sa.aggregate_masked(masked)
    _assert_tree_close(total, {"w": sum(u["w"] for u in ups),
                               "b": {"x": sum(u["b"]["x"] for u in ups)}})


def test_masked_update_hides_individual():
    """A single masked upload is dominated by mask noise (privacy)."""
    ups = _updates(3)
    update = _torch(ups[0])
    masked = sa.mask_update(update, 0, 3, round_idx=0, scale=100.0)
    assert torch.equal(update["w"], torch.tensor(ups[0]["w"]))  # the input is left alone
    diff = masked["w"].numpy() - ups[0]["w"]
    assert np.abs(diff).mean() > 10.0  # mask >> signal
    corr = np.corrcoef(masked["w"].numpy(), ups[0]["w"])[0, 1]
    assert abs(corr) < 0.9
    # the masks are one generator per pair drawn leaf by leaf in the
    # reference's flattening order (b/x, then w): client 0's upload is its
    # update plus the masks of pairs (0, 1) and (0, 2)
    want = {p: x.clone() for p, x in flatten_with_paths(update)}
    for peer in (1, 2):
        seed = sa.pair_seed(0, peer, 0)
        g = torch.Generator().manual_seed(seed)
        tree = dict(flatten_with_paths(sa._mask_tree(update, seed, 100.0)))
        for p in ("b/x", "w"):
            m = 100.0 * torch.randn(want[p].shape, generator=g)
            assert torch.equal(tree[p], m)
            want[p] += m
    for p, x in flatten_with_paths(masked):
        assert torch.equal(x, want[p])


@pytest.mark.cuda
def test_secure_fedavg_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ups = _updates(3, shape=(1 << 16,), seed=5)
    secure = sa.secure_fedavg([_torch(u, "cuda") for u in ups], round_idx=2)
    assert all(x.device.type == "cuda" for _, x in flatten_with_paths(secure))
    _assert_tree_close(secure, _plain_mean(ups))

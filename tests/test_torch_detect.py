"""The port's NMS (K3) and pairwise IoU (K2) (``repro_torch.kernels``)
held against the reference.

On the CPU the port's wrapper runs the plain PyTorch scan; both it and the
forced plain version (``impl="ref"``) must equal the reference's Pallas
``nms`` (interpret mode) and its NumPy oracle ``ref.nms_np`` bit for bit
(tolerance: none, compared as int32 bit patterns). The cases mirror
tests/test_detect.py's NMS goldens and the cases ``chip_smoke.py`` holds the
CUDA kernel to on the card. The pairwise IoU's plain version must equal the
reference's Pallas ``pairwise_iou`` (interpret mode) and its oracle
``ref.pairwise_iou_np`` bit for bit too, IoU and GIoU, degenerate boxes
included. The cases that run a CUDA kernel itself against its plain version
need a card and skip without one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import detect as jdetect
from repro.kernels import ref as jref
from repro_torch.kernels import detect, ops

SHAPES = [(1, 1), (8, 16), (64, 100), (4, 1024)]
KINDS = ["random", "ties", "degenerate", "all_suppressed", "max_keep", "score_thresh"]


def make_case(kind: str, B: int, N: int, seed: int = 0):
    """-> (boxes (B, N, 4) f32, scores (B, N) f32, iou_thresh, score_thresh,
    max_keep) for one NMS case kind."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.1, 0.9, (B, N, 2))
    wh = rng.uniform(0.02, 0.5, (B, N, 2))
    scores = rng.uniform(0, 1, (B, N))
    iou, sthr, mk = 0.4, 0.0, 0
    if kind == "ties":  # few score levels and repeated boxes: ties broken by index
        scores = np.round(scores * 4) / 4
        xy[:, 1::2] = xy[:, 0::2][:, : xy[:, 1::2].shape[1]]
    elif kind == "degenerate":  # zero-area and negative-extent boxes
        wh[:, 0::3, 0] = 0.0
        wh[:, 1::3] *= -1.0
        wh[:, 2::5, 1] = 0.0
    elif kind == "all_suppressed":  # one cluster per image: a single survivor
        xy = 0.5 + rng.uniform(-0.01, 0.01, (B, N, 2))
        wh = 0.3 + rng.uniform(-0.01, 0.01, (B, N, 2))
        iou = 0.5
    elif kind == "max_keep":  # a disjoint strip: every box survives NMS
        xy[..., 0] = np.linspace(0.0, 1.0, N)[None]
        xy[..., 1] = 0.5
        wh[:] = 0.5 / max(N, 1)
        mk = max(1, N // 3)
    elif kind == "score_thresh":
        sthr = 0.5
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    return boxes, scores.astype(np.float32), iou, sthr, mk


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("B,N", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_nms_bit_for_bit_with_reference(kind, B, N):
    boxes, scores, iou, sthr, mk = make_case(kind, B, N)
    oracle = jref.nms_np(boxes, scores, iou, sthr, mk)
    pallas = jdetect.nms(jnp.asarray(boxes), jnp.asarray(scores), iou_thresh=iou,
                         score_thresh=sthr, max_keep=mk, interpret=True)
    np.testing.assert_array_equal(bits(pallas), bits(oracle))
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    for impl in ops.IMPLS:
        keep = ops.nms(tb, ts, iou_thresh=iou, score_thresh=sthr, max_keep=mk, impl=impl)
        np.testing.assert_array_equal(bits(keep.numpy()), bits(oracle), err_msg=impl)
    if kind == "all_suppressed":
        assert (oracle.sum(-1) == 1).all()
    if kind == "max_keep":
        assert (oracle.sum(-1) == mk).all()


def test_unbatched_boxes_and_tie_order():
    """(N, 4) input without a batch dim; of identical tied boxes index 0 wins
    (stable sort), as tests/test_detect.py pins for the reference."""
    bx = np.tile(np.asarray([[0.5, 0.5, 0.2, 0.2]], np.float32), (6, 1))
    sc = np.full(6, 0.9, np.float32)
    keep = ops.nms(torch.from_numpy(bx), torch.from_numpy(sc), iou_thresh=0.5)
    assert keep.shape == (6,)
    np.testing.assert_array_equal(keep.numpy(), [1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(keep.numpy(), jref.nms_np(bx, sc, 0.5))


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch():
    boxes, scores, iou, sthr, mk = make_case("random", 8, 16)
    before = detect.nms_keep.launches
    keep = detect.nms(torch.from_numpy(boxes), torch.from_numpy(scores), iou_thresh=iou)
    assert detect.nms_keep.launches == before
    np.testing.assert_array_equal(bits(keep.numpy()), bits(jref.nms_np(boxes, scores, iou)))


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        ops.nms(torch.zeros(1, 4), torch.zeros(1), impl="fast")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_equals_plain_version_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for B, N in SHAPES:
        boxes, scores, iou, sthr, mk = make_case(kind, B, N)
        tb, ts = torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()
        kern = ops.nms(tb, ts, iou_thresh=iou, score_thresh=sthr, max_keep=mk)
        plain = ops.nms(tb, ts, iou_thresh=iou, score_thresh=sthr, max_keep=mk, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(kern.view(torch.int32), plain.view(torch.int32)), (B, N)
        np.testing.assert_array_equal(bits(kern.cpu().numpy()),
                                      bits(jref.nms_np(boxes, scores, iou, sthr, mk)))


IOU_SHAPES = [(12, 64, 3), (1, 1, 1), (8, 128, 128), (4, 300, 7), (2, 1000, 1000)]
IOU_KINDS = ["random", "degenerate"]


def make_iou_case(kind: str, B: int, N: int, M: int, seed: int = 0):
    """-> (a (B, N, 4), b (B, M, 4)) f32 center-format boxes. ``degenerate``
    sets zero widths, zero heights and negative extents on a share of both
    sets and repeats a-boxes in b (IoU exactly 1)."""
    rng = np.random.default_rng(seed)

    def boxes(n):
        return np.concatenate([rng.uniform(0.1, 0.9, (B, n, 2)), rng.uniform(0.02, 0.5, (B, n, 2))], -1)

    a, b = boxes(N), boxes(M)
    if kind == "degenerate":
        for x in (a, b):
            x[:, 0::3, 2] = 0.0
            x[:, 1::4, 2:] *= -1.0
            x[:, 2::5, 3] = 0.0
        k = min(N, M) // 2
        b[:, :k] = a[:, :k]
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("giou", [False, True])
@pytest.mark.parametrize("kind", IOU_KINDS)
@pytest.mark.parametrize("B,N,M", IOU_SHAPES[:4])
def test_plain_pairwise_iou_bit_for_bit_with_reference(B, N, M, kind, giou):
    a, b = make_iou_case(kind, B, N, M)
    oracle = jref.pairwise_iou_np(a, b, giou=giou)
    pallas = jdetect.pairwise_iou(jnp.asarray(a), jnp.asarray(b), giou=giou, interpret=True)
    np.testing.assert_array_equal(bits(pallas), bits(oracle))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = detect.pairwise_iou.launches
    for impl in ops.IMPLS:
        out = ops.pairwise_iou(ta, tb, giou=giou, impl=impl)
        assert out.shape == (B, N, M)
        np.testing.assert_array_equal(bits(out.numpy()), bits(oracle), err_msg=impl)
    assert detect.pairwise_iou.launches == before  # the CPU takes the plain version
    if kind == "degenerate" and not giou:
        assert (out[:, 0::3].numpy() == 0).all()  # zero-width a-boxes score 0


def test_plain_pairwise_iou_unbatched_and_large():
    """(N, 4) x (M, 4) without a batch dim, and the largest card case."""
    a, b = make_iou_case("random", 1, 37, 5)
    out = ops.pairwise_iou(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    np.testing.assert_array_equal(bits(out.numpy()), bits(jref.pairwise_iou_np(a[0], b[0])))
    B, N, M = IOU_SHAPES[-1]
    a, b = make_iou_case("degenerate", B, N, M)
    for giou in (False, True):
        out = ops.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b), giou=giou)
        np.testing.assert_array_equal(bits(out.numpy()), bits(jref.pairwise_iou_np(a, b, giou=giou)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", IOU_KINDS)
def test_cuda_iou_kernel_equals_plain_version_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for B, N, M in IOU_SHAPES:
        a, b = make_iou_case(kind, B, N, M)
        ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        for giou in (False, True):
            kern = ops.pairwise_iou(ta, tb, giou=giou)
            plain = ops.pairwise_iou(ta, tb, giou=giou, impl="ref")
            torch.cuda.synchronize()
            assert torch.equal(kern.view(torch.int32), plain.view(torch.int32)), (B, N, M, giou)
            np.testing.assert_array_equal(bits(kern.cpu().numpy()),
                                          bits(jref.pairwise_iou_np(a, b, giou=giou)))

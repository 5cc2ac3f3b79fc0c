"""The port's NMS (K3) and pairwise IoU (K2) (``repro_torch.kernels``)
held against the reference.

On the CPU the port's wrapper runs the plain PyTorch scan; both it and the
forced plain version (``impl="ref"``) must equal the reference's Pallas
``nms`` (interpret mode) and its NumPy oracle ``ref.nms_np`` bit for bit
(tolerance: none, compared as int32 bit patterns). The cases mirror
tests/test_detect.py's NMS goldens and the cases ``chip_smoke.py`` holds the
CUDA kernel to on the card, among them boxes whose IoU lands exactly on the
threshold. A NumPy model of the card kernel's algorithm (every pair's IoU
packed into 32-bit words, then the ordered resolve word by word) is held
bitwise against the plain scan and the reference's oracle, at word edges
too, and pinned to the no-cascade rule. The pairwise IoU's plain version must equal the
reference's Pallas ``pairwise_iou`` (interpret mode) and its oracle
``ref.pairwise_iou_np`` bit for bit too, IoU and GIoU, degenerate boxes
included. The cases that run a CUDA kernel itself against its plain version
need a card and skip without one.
"""
import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import detect as jdetect
from repro.kernels import ref as jref
from repro_torch.kernels import detect, ops, ref

SHAPES = [(1, 1), (8, 16), (64, 100), (4, 1024)]
KINDS = ["random", "ties", "degenerate", "all_suppressed", "max_keep", "score_thresh", "iou_ties"]
# N at the card kernel's 32-bit word edges: one box past one and two words
WORD_EDGES = [(3, 33), (2, 65)]


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
    elif kind == "iou_ties":  # boxes 1/4 wide on a 1/16 grid: 2/16 apart, IoU is f32(1/3)
        xy = rng.integers(4, 13, (B, N, 2)) / 16.0
        wh = np.full((B, N, 2), 0.25)
        iou = 1.0 / 3.0
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    return boxes, scores.astype(np.float32), iou, sthr, mk


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _words(flags: np.ndarray) -> np.ndarray:
    """(..., N) bools -> (..., ceil(N/32)) uint32, bit j % 32 of word j // 32."""
    n = flags.shape[-1]
    padded = np.zeros(flags.shape[:-1] + (-(-n // 32) * 32,), np.uint64)
    padded[..., :n] = flags
    shifted = padded.reshape(flags.shape[:-1] + (-1, 32)) << np.arange(32, dtype=np.uint64)
    return shifted.sum(-1).astype(np.uint32)


def bitmask_keep(boxes_s: np.ndarray, valid_s: np.ndarray, iou_thresh: float):
    """NumPy model of ``csrc/nms.cu::nms_bitmask_kernel`` -> (keep_s (B, N)
    f32, count of pairs whose IoU equals the threshold). Per image: the
    corners, every pair's IoU (the reference's f32 ops in its order), bit j of
    row i's word j // 32 set where j > i and IoU > thresh; then word k's
    chain (row 32k + r, live and not yet suppressed, ORs in its word k) and
    the rows of word k still kept OR their later words in."""
    f = np.float32
    B, N = valid_s.shape
    keep = np.empty((B, N), np.float32)
    ties = 0
    for b in range(B):
        bx = boxes_s[b]
        x1, y1 = bx[:, 0] - bx[:, 2] * f(0.5), bx[:, 1] - bx[:, 3] * f(0.5)
        x2, y2 = bx[:, 0] + bx[:, 2] * f(0.5), bx[:, 1] + bx[:, 3] * f(0.5)
        area = np.maximum((x2 - x1) * (y2 - y1), f(0.0))
        ix = np.maximum(np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None]), f(0.0))
        iy = np.maximum(np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None]), f(0.0))
        inter = np.maximum(ix * iy, f(0.0))
        iou = inter / np.maximum((area[:, None] + area[None]) - inter, f(1e-9))
        later = np.arange(N)[None] > np.arange(N)[:, None]
        ties += int((later & (iou == f(iou_thresh))).sum())
        mask = _words(later & (iou > f(iou_thresh)))  # (N, words)
        live = _words(valid_s[b] > 0)
        sup = np.zeros(mask.shape[1], np.uint32)
        for k in range(mask.shape[1]):
            s, lv = int(sup[k]), int(live[k])
            for r in range(min(32, N - 32 * k)):
                if lv >> r & 1 and not s >> r & 1:
                    s |= int(mask[32 * k + r, k])
            sup[k] = s
            for r in range(32):
                if (lv & ~s) >> r & 1:
                    sup[k + 1:] |= mask[32 * k + r, k + 1:]
        suppressed = (sup[np.arange(N) // 32] >> (np.arange(N) % 32).astype(np.uint32)) & 1
        keep[b] = np.where(suppressed == 1, f(0.0), valid_s[b])
    return keep, ties


@pytest.mark.parametrize("B,N", SHAPES + WORD_EDGES)
@pytest.mark.parametrize("kind", KINDS)
def test_bitmask_model_equals_the_scan_and_the_reference(kind, B, N):
    """The card kernel's mask-and-resolve algorithm, modelled in NumPy, keeps
    exactly what the plain scan keeps (its operands from the port's sort),
    and after the cap and scatter what the reference's oracle keeps."""
    boxes, scores, iou, sthr, mk = make_case(kind, B, N)
    order, boxes_s, valid_s = ref.sort_by_score(torch.from_numpy(boxes), torch.from_numpy(scores), sthr)
    model, ties = bitmask_keep(boxes_s.numpy(), valid_s.numpy(), iou)
    np.testing.assert_array_equal(bits(model), bits(ref.nms_keep(boxes_s, valid_s, iou).numpy()))
    full = ref.finish(order, torch.from_numpy(model), mk)
    np.testing.assert_array_equal(bits(full.numpy()), bits(jref.nms_np(boxes, scores, iou, sthr, mk)))
    if kind == "iou_ties" and N >= 16:
        assert ties > 0  # the strict `>` decides some pair


def test_bitmask_model_keeps_no_cascade_across_a_word_edge():
    """Box 0 suppresses box 31, which overlaps box 32 more than the threshold
    but, suppressed, must not suppress it: 32 stays kept. The same inside
    one word: 33 suppresses 34, and 35 stays kept. The other boxes are
    specks far apart."""
    N = 40
    boxes = np.zeros((1, N, 4), np.float32)
    boxes[0, :, 0] = np.linspace(0.02, 0.98, N)
    boxes[0, :, 1] = 0.05
    boxes[0, :, 2:] = 0.001
    for first, y in ((0, 0.5), (33, 0.8)):
        boxes[0, first] = [0.30, y, 0.2, 0.2]
    for second, third, y in ((31, 32, 0.5), (34, 35, 0.8)):
        boxes[0, second] = [0.35, y, 0.2, 0.2]  # IoU 0.6 with the first and the third
        boxes[0, third] = [0.40, y, 0.2, 0.2]  # IoU 1/3 with the first
    valid = np.ones((1, N), np.float32)
    want = valid.copy()
    want[0, [31, 34]] = 0.0
    model, _ = bitmask_keep(boxes, valid, 0.5)
    np.testing.assert_array_equal(model, want)
    np.testing.assert_array_equal(ref.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid),
                                               0.5).numpy(), want)


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
    # the bitmask kernel up to N = 1024 (word edges, eval's N = 64), the scan above
    for B, N in SHAPES + WORD_EDGES + [(8, 64), (2, 2048)]:
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

"""The port's FedYOLOv3 (``repro_torch.models``) held against the reference.

Both packages get identical weights: the reference's ``init_params`` draws
them and ``convert.from_reference`` carries them into the port's module.
Tolerances: raw head outputs rtol 1e-4 / atol 1e-5 (two f32 convolution
implementations sum in different orders); ``decode_boxes`` rtol 1e-6 /
atol 1e-6 on identical raw inputs (sigmoid/exp differ by an ulp, and w/h
reach anchor * e^6); templates, configs, padding and the weight round trip
exactly.
"""
import dataclasses

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import params as jparams
from repro.models import yolov3 as jyolo
from repro_torch.configs import get_arch
from repro_torch.models import convert, yolov3
from repro_torch.models.params import count_params, flatten_with_paths, init_params

CONFIGS = ["reduced", "full"]


def cfgs(which):
    j, t = jget_arch("fedyolov3"), get_arch("fedyolov3")
    return (j.reduced(), t.reduced()) if which == "reduced" else (j, t)


def reference_weights(cfg, seed=0):
    """The reference's own init, as a tree of NumPy arrays."""
    p = jparams.init_params(jyolo.template(cfg), jax.random.key(seed), jnp.float32)
    return jax.tree.map(np.asarray, p)


def ported(tcfg, tree):
    model = yolov3.FedYOLOv3(tcfg)
    model.load_state_dict(convert.from_reference(tree))
    return model.eval()


@pytest.mark.parametrize("which", CONFIGS)
def test_config_and_template_match_reference(which):
    jcfg, tcfg = cfgs(which)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jt = jyolo.template(jcfg)
    ref_leaves = [
        ("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), info.shape)
        for path, info in jax.tree_util.tree_flatten_with_path(jt, is_leaf=jparams.is_info)[0]
    ]
    port_leaves = [(path, info.shape) for path, info in flatten_with_paths(yolov3.template(tcfg))]
    assert port_leaves == ref_leaves  # same paths, same order (heads, stages, stem), same shapes
    assert ref_leaves[0][0] == "heads/0" and ref_leaves[-1][0] == "stem"
    assert count_params(yolov3.template(tcfg)) == jparams.count_params(jt)
    assert yolov3.grid_sizes(tcfg, 416) == jyolo.grid_sizes(jcfg, 416)


def test_full_size_model_has_the_published_widths():
    _, tcfg = cfgs("full")
    model = yolov3.FedYOLOv3(tcfg)
    assert [s.down.shape[0] for s in model.stages] == [64, 128, 256, 512, 1024]
    assert sum(p.numel() for p in model.parameters()) == 13_312_864


@pytest.mark.parametrize("size", range(1, 12))
def test_same_pads_follow_xla(size):
    for k in (1, 3):
        for stride in (1, 2):
            (ref,) = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
            assert yolov3.same_pads(size, k, stride) == tuple(ref), (k, stride)


@pytest.mark.parametrize("img", [32, 64, 36])
def test_forward_matches_reference(img):
    """Img 32 and 64 give even inputs to every stride-2 conv ((0, 1) pads);
    36 gives the last one an odd input (9 -> 5, pads (1, 1))."""
    jcfg, tcfg = cfgs("reduced")
    tree = reference_weights(jcfg, seed=1)
    images = np.random.default_rng(img).normal(0, 1, (2, img, img, 3)).astype(np.float32)
    ref = jyolo.forward(tree, jnp.asarray(images), jcfg)
    with torch.no_grad():
        out = ported(tcfg, tree)(torch.from_numpy(images))
    assert len(out) == 3
    for r, o in zip(ref, out):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_decode_boxes_matches_reference():
    raw = np.random.default_rng(5).normal(0, 2, (2, 8, 8, 3, 8)).astype(np.float32)
    for anchors in jyolo.ANCHORS:
        ref = jyolo.decode_boxes(jnp.asarray(raw), anchors)
        out = yolov3.decode_boxes(torch.from_numpy(raw), anchors)
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", CONFIGS)
def test_convert_round_trip_is_bit_exact(which):
    """The reference's own weights (reduced) and the port's init carried to
    the reference layout (full, where the reference's init is slow here)."""
    jcfg, tcfg = cfgs(which)
    if which == "reduced":
        tree = reference_weights(jcfg)
    else:
        tree = convert.to_reference(yolov3.FedYOLOv3(tcfg, torch.Generator().manual_seed(2)))
    back = convert.to_reference(ported(tcfg, tree))
    ref_flat = dict(flatten_with_paths(tree))
    back_flat = dict(flatten_with_paths(back))
    assert list(back_flat) == list(ref_flat)
    assert isinstance(back["stages"], tuple) and isinstance(back["heads"], tuple)
    for k, v in ref_flat.items():
        assert back_flat[k].dtype == v.dtype and back_flat[k].shape == v.shape
        np.testing.assert_array_equal(back_flat[k].view(np.int32), v.view(np.int32), err_msg=k)


def test_port_init_is_seeded_and_in_reference_layout():
    _, tcfg = cfgs("reduced")
    t = yolov3.template(tcfg)
    a = init_params(t, torch.Generator().manual_seed(3))
    b = init_params(t, torch.Generator().manual_seed(3))
    c = init_params(t, torch.Generator().manual_seed(4))
    for (pa, la), (_, lb), (_, lc) in zip(*(flatten_with_paths(x) for x in (a, b, c))):
        assert torch.equal(la, lb) and not torch.equal(la, lc), pa
    # heads are small_normal (std 0.02); convs are fan-in scaled
    assert abs(float(a["heads"][0].std()) - 0.02) < 0.005
    stem_std = 1 / np.sqrt(3 * 3 * 3)
    assert abs(float(a["stem"].std()) - stem_std) < 0.2 * stem_std

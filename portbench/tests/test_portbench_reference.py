"""The plain reference (``portbench/reference``) against the port, on the
CPU at small sizes: the row's layout, one step's loss and gradient, a whole
cell's check; the lower-precision control and the faults a training cell
can have make ``correct`` false; and neither JAX nor the JAX package, nor
in the reference the port, is loaded."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _pb_tiny import ROOT, TINY, make_root, run_cell  # noqa: E402

from portbench import check, weights  # noqa: E402
from portbench.reference import fed, layout  # noqa: E402
from portbench.traffic import scenes, tokens  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import packing, rounds  # noqa: E402
from repro_torch.core.server import FLServer  # noqa: E402
from repro_torch.models.params import _fan_in, flatten_with_paths  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench"))


def _sizes(config: str, extra: dict | None = None) -> dict:
    conf = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    return {**conf["sizes"], **(extra or {})}


def _cfg(config: str, sizes: dict, **kw):
    return dataclasses.replace(get_arch(config), **sizes, **kw)


LAYOUTS = [("fedyolov3", "yolo", None), ("fedyolov3", "yolo", TINY["ty"][3]),
           ("mamba2-1.3b", "mamba2", None), ("mamba2-1.3b", "mamba2", TINY["tm"][3])]


@pytest.mark.parametrize("config,family,extra", LAYOUTS)
def test_layout_is_the_programs(config, family, extra):
    """Leaf for leaf: name, shape, offset, score buckets and how it is
    drawn, at full and at small size (exact)."""
    sizes = _sizes(config, extra)
    cfg = _cfg(config, sizes)
    tpl = rounds.make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    ours = layout.leaves_of(family, sizes)
    infos = dict(flatten_with_paths(tpl))
    runs = list(layout.bucket_runs(ours, sizes))
    assert [l.name for l in ours] == [s.name for s in spec.slots]
    for leaf, slot, (off, b0, nb, _) in zip(ours, spec.slots, runs):
        info = infos[slot.name]
        assert (leaf.shape, leaf.offset, b0, nb) == (slot.shape, slot.offset, slot.bucket_off,
                                                       slot.n_buckets)
        kind = {"normal": "normal", "small_normal": "small", "zeros": "zeros", "ones": "ones"}
        assert leaf.init == kind[info.init]
        if info.init == "normal":
            assert leaf.std == pytest.approx(info.scale / _fan_in(info) ** 0.5, rel=1e-12)
        elif info.init == "small_normal":
            assert leaf.std == 0.02 * info.scale
    assert layout.n_buckets(sizes) == spec.n_buckets
    if extra is None:
        n = ours[-1].offset + ours[-1].size
        assert n == {"fedyolov3": 13_312_864, "mamba2-1.3b": 1_343_548_416}[config] == spec.n_total


@pytest.mark.parametrize("cell", ["ty", "tm"])
def test_one_step_agrees_with_the_port(cell):
    """The reference's loss and gradient at the benchmark's initial row on
    a pool batch against the port's loss function over views of the same
    row: the loss within 1e-5 and each leaf's gradient within 1e-4 of its
    norm (f32 sums in other orders; the port's SSD on its plain path)."""
    config, base, mix_name, extra, traffic = TINY[cell]
    sizes = _sizes(base, extra)
    mix = {**json.loads((ROOT / "portbench" / "traffic" / f"{mix_name}.json").read_text()),
           **traffic}
    family = "yolo" if base == "fedyolov3" else "mamba2"
    leaves = layout.leaves_of(family, sizes)
    row = weights.initial_row(leaves, 5, "cpu")
    gen = scenes if family == "yolo" else tokens
    batch = fed._pick(gen.pool(mix, sizes, 5, "cpu")[0], 0, 0)
    cfg = _cfg(base, sizes)
    tpl = rounds.make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    flat = row.clone().requires_grad_(True)
    loss_p, _ = rounds.loss_for(cfg)(packing.unpack_views(spec, flat, tpl), batch)
    (g_p,) = torch.autograd.grad(loss_p, flat)
    loss_r, g_r = fed.grad(family, row, leaves, batch, sizes)
    assert float(loss_p.detach()) == pytest.approx(float(loss_r), rel=1e-5)
    for leaf in leaves:
        a, b = (g[leaf.offset:leaf.offset + leaf.size] for g in (g_p, g_r))
        assert float(torch.linalg.vector_norm(a - b)) <= 1e-4 * float(torch.linalg.vector_norm(b))


@pytest.mark.parametrize("cell", ["ty", "tm"])
def test_a_cell_is_correct_on_the_cpu(root, cell):
    out = run_cell(root, cell)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "compared"
    assert all(v["value"] <= v["limit"] for v in out["compared"].values())


@pytest.mark.parametrize("cell", ["ty", "tm"])
def test_the_lower_precision_control_fails(root, cell):
    """The reference with its products in bfloat16 (the CPU has no TF32),
    put in the program's place, fails the f32 reference's comparison."""
    from portbench import run, spec

    c = spec.load(root, cell)
    pool = run.generator(c.mix).pool(c.mix, c.config["sizes"], 9, "cpu")
    ref = run.reference(c, pool, 9, "cpu")
    control = run.reference(c, pool, 9, "cpu", mode="bf16")
    assert not check.passes(check.gaps(control, ref), c.limits)


def _unchanged(orig):
    def run_round(self, batch):
        saved = {k: v.clone() for k, v in self.state["opt"].items()}
        params = self.state["params"].clone()
        rec = orig(self, batch)
        self.state["params"].copy_(params)
        for k, v in saved.items():
            self.state["opt"][k].copy_(v)
        return rec
    return run_round


def _half_batch(orig):
    def run_round(self, batch):
        cut = lambda t: t[:, :, : t.shape[2] // 2]
        half = {"images": cut(batch["images"]),
                "targets": [{k: cut(v) for k, v in s.items()} for s in batch["targets"]]} \
            if "images" in batch else {"tokens": cut(batch["tokens"])}
        return orig(self, half)
    return run_round


@pytest.mark.parametrize("cell", ["ty", "tm"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
def test_a_broken_round_is_not_correct(root, cell, fault, monkeypatch):
    """The whole run but the look for a card, with the port's round broken
    underneath: a step that returns its state unchanged, or one that leaves
    half of each batch out (the mean over the rest)."""
    monkeypatch.setattr(FLServer, "run_round", fault(FLServer.run_round))
    assert run_cell(root, cell)["correct"] is False


CHECK_MODULES = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(body: str) -> set[str]:
    code = CHECK_MODULES.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cells_cpu_run_loads_no_jax(root):
    """After a whole CPU run of a cell, no module whose top-level name is
    jax, jaxlib, flax or repro (compared whole) is loaded."""
    body = ("from pathlib import Path\nfrom portbench import run\n"
            f"assert run.main(['--workload', 'ty', '--seed', '4', '--seconds', '0.3'], "
            f"device='cpu', root=Path({str(root)!r})) == 0")
    loaded = _modules(body)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules("import portbench.reference.fed, portbench.check, portbench.weights\n"
                      "import portbench.traffic.scenes, portbench.traffic.tokens")
    assert not loaded & {"repro_torch", "jax", "jaxlib", "flax", "repro"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,full", [("ty", "yolo_eq6_c3_b8"), ("tm", "mamba2_eq6_c2_s2k")])
def test_the_tf32_control_fails_on_the_card(root, cell, full):
    """On the card the control is the configurations' f32 with TF32 on, the
    nearest precision below: put in the program's place, it fails the
    limits of the cell it stands for (the small cells' own limits are
    looser, for the CPU's rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    from portbench import run, spec

    c = spec.load(root, cell)
    pool = run.generator(c.mix).pool(c.mix, c.config["sizes"], 9, "cuda")
    ref = run.reference(c, pool, 9, "cuda")
    control = run.reference(c, pool, 9, "cuda", mode="tf32")
    limits = json.loads((ROOT / "portbench" / "limits" / f"{full}.json").read_text())
    assert not check.passes(check.gaps(control, ref), limits)

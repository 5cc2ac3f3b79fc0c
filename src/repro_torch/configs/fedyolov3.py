"""fedyolov3 — the paper's own model (port of ``repro/configs/fedyolov3.py``).

The ArchConfig fields are repurposed: d_model = base conv width, n_layers =
number of darknet residual stages, n_heads = anchors per scale, vocab_size =
classes.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="fedyolov3",
    family="yolo",
    n_layers=5,  # darknet-lite residual stages
    d_model=32,  # base conv channels
    n_heads=3,  # anchor boxes per scale (B in the paper)
    n_kv_heads=3,
    d_ff=0,
    vocab_size=3,  # C classes (e.g. fire / smoke / disaster)
    causal=False,
    modality="image",
    source="AAAI 2020 FedVision (Redmon & Farhadi 2018)",
)

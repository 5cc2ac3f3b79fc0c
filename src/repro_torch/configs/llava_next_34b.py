"""llava-next-34b [vlm] — anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The vision tower (ViT/SigLIP) + projector is a stub: the
backbone is given pre-computed patch embeddings of shape
(B, n_image_tokens, d_model) which the language backbone consumes, prepended
to the text tokens. n_image_tokens=2880 models anyres tiling (5 tiles x 576).

Port of ``repro/configs/llava_next_34b.py``: the same fields.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    modality="vlm",
    n_image_tokens=2880,
    # 56 q heads = 8 kv groups of 7; pad each group to 8 (64 total, one
    # masked dead head per group) so heads shard 16-way with the exact
    # original GQA grouping preserved. See DESIGN.md §4.
    q_group_pad=8,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

"""Device resolution for every entry point of the port.

There is no silent fallback: asking for ``"cuda"`` on a machine without a
card raises, and only an explicit ``"cpu"`` runs on the host. Resolving a
CUDA device also pins the numerics the reference computes (see
:func:`resolve`).
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``device`` -> ``torch.device``, raising if it names an absent card.

    For CUDA it turns TF32 off for convolutions and matmuls (cuDNN defaults
    convolutions to TF32, about 3 decimal digits; the reference computes
    f32) and fixes cuDNN's algorithm choice (no autotuning, deterministic
    algorithms): the padded-batch pin needs every launch of the fixed-shape
    serving batch to run the same arithmetic whatever the other slots hold.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the host"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; the port runs on 'cuda' or 'cpu'")
    return dev

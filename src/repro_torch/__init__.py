"""FedVision reproduction, PyTorch/CUDA port of the ``repro`` package.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``repro/X/y.py`` -> ``repro_torch/X/y.py``) and never imports it or
JAX. Every entry point takes an explicit ``device`` (default ``"cuda"``) and
refuses to run on the CPU unless asked to.
"""

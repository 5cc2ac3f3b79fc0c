"""Build and bind the port's CUDA kernels at first use.

The sources under ``kernels/csrc/`` (``nms.cu`` K3, ``bucket_reduce.cu`` K1,
``iou.cu`` K2 and the shared ``errors.cu``) are compiled for ``sm_90a`` by
one ``torch.utils.cpp_extension.load`` call into ``build/torch_ext/`` at the
root of the checkout, the first time a kernel is launched in a process;
ninja runs one ``nvcc`` per source in parallel. The sources expose a plain
C interface and include no PyTorch header, so a build takes seconds, not
minutes; the library is bound with ``ctypes``, every pointer and the stream
as ``c_void_p``. A failed build raises: nothing falls back to the plain
versions.

Flags: ``-O3``, ``sm_90a``, and ``-fmad=false`` so no product is contracted
into an FMA (the bit-for-bit contract with ``kernels/ref.py``); no fast
math, so division stays IEEE round-to-nearest.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = ("nms.cu", "bucket_reduce.cu", "iou.cu", "errors.cu")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false"]

_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load_locked() -> ctypes.CDLL:
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(
        name="repro_torch_kernels",
        sources=[str(CSRC / name) for name in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cuda_cflags=CUDA_FLAGS,
        is_python_module=False,
        verbose=False,
    )
    lib = ctypes.CDLL(path)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.nms_keep_launch.argtypes = [p, p, p, i, i, f, p]
    lib.packed_bucket_reduce_launch.argtypes = [p, p, p, p, p, p, i, ll, i, p]
    lib.pairwise_iou_launch.argtypes = [p, p, p, i, i, i, i, p]
    for fn in (lib.nms_keep_launch, lib.packed_bucket_reduce_launch, lib.pairwise_iou_launch):
        fn.restype = i
    lib.kernel_error_string.argtypes = [i]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call in a process)."""
    with _lock:
        return _load_locked()


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code:
        raise RuntimeError(f"{what} failed: {lib.kernel_error_string(code).decode()} (cudaError {code})")

"""Build and bind the port's CUDA kernels at first use.

The sources under ``kernels/csrc/`` (``nms.cu`` K3, ``bucket_reduce.cu`` K1,
``iou.cu`` K2, ``quant_reduce.cu`` K4 and K7, ``row_quant.cu`` K5a, K5b,
K12a and K12b, ``grouped_reduce.cu`` K6, ``masked_sum.cu`` K8,
``flash_attention.cu`` K9, ``ssd_scan.cu`` K10, ``fedavg.cu`` K11, the
shared ``errors.cu``, the headers ``block_amax.cuh`` (the CTA-wide amax of
the generic K4/K7 and K5a/K12a kernels) and ``quant_tile.cuh`` (the tile
machinery of their whole-tile kernels: ``cp.async`` ring, warp amax,
persistent grid, the exact per-block divide), and the header
``mma_tf32.cuh`` that K9 and K10 share: the 3xTF32 split, the tf32
``mma.sync`` and ``cp.async``) are compiled for ``sm_90a`` by
one ``torch.utils.cpp_extension.load`` call into ``build/torch_ext/`` at the
root of the checkout, the first time a kernel is launched in a process;
ninja runs one ``nvcc`` per source in parallel. The sources expose a plain
C interface and include no PyTorch header, so a build takes seconds, not
minutes; the library is bound with ``ctypes``, every pointer and the stream
as ``c_void_p``. A failed build raises: nothing falls back to the plain
versions.

Flags: ``-O3``, ``sm_90a``, and ``-fmad=false`` so no product is contracted
into an FMA (the bit-for-bit contract with ``kernels/ref.py``); no fast
math, so division stays IEEE round-to-nearest. K9 and K10, held to their
plain versions at a tolerance, run their products on the tensor cores
through a 3xTF32 split; cuBLAS and cuDNN stay TF32-off (``device.resolve``).

:func:`inspect` compiles sources one by one with ``-Xptxas -v`` and counts
the tensor-core instructions in their SASS (``scripts/lm_kernels_check.py``
and ``chip_smoke.py`` phase 8 print both).
"""
from __future__ import annotations

import ctypes
import functools
import re
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = ("nms.cu", "bucket_reduce.cu", "iou.cu", "quant_reduce.cu", "row_quant.cu",
           "grouped_reduce.cu", "masked_sum.cu", "flash_attention.cu", "ssd_scan.cu", "fedavg.cu",
           "errors.cu")
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
    p, i, f, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong, ctypes.c_uint
    argtypes = {
        "nms_keep_launch": [p, p, p, i, i, f, p],
        "packed_bucket_reduce_launch": [p, p, p, p, p, p, i, ll, i, p],
        "pairwise_iou_launch": [p, p, p, i, i, i, i, p],
        "quant_reduce_launch": [p, p, p, i, ll, i, f, i, u, p],
        "quant_reduce_tile_residency": [i],
        "quantize_rows_launch": [p, p, p, i, ll, i, i, p],
        "quantize_rows_tile_residency": [],
        "dequantize_rows_launch": [p, p, p, i, i, ll, i, i, p],
        "dequantize_tree_launch": [p, i, u, p],
        "grouped_reduce_launch": [p, p, p, i, i, ll, p],
        "masked_u32_sum_launch": [p, p, p, i, ll, p],
        "flash_attention_launch": [p, p, p, p, i, i, i, i, i, i, ctypes.POINTER(ll), i, i, f, p],
        "ssd_chunk_scan_launch": [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p],
        "fedavg_masked_mean_launch": [p, p, p, p, i, i, ll, p],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
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


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``device`` as its last argument; raise on a non-zero ``cudaError_t``."""
    lib = library()
    with torch.cuda.device(device):
        code = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    check(lib, code, name)


def forward_only(what: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and an input requires grad. The kernel
    wrappers write into fresh buffers with no ``grad_fn``: called under
    training they would drop the gradient silently. Training reaches K9 and
    K10 through ``kernels.ops.flash_attention_trainable`` and
    ``ssd_full_trainable``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} is a forward-only kernel wrapper and its output has no "
                           f"gradient; train through kernels.ops.flash_attention_trainable or "
                           f"ssd_full_trainable")


def inspect(sources: tuple[str, ...]) -> dict[str, dict]:
    """Compile each of ``sources`` (names under ``csrc/``) alone with the
    build's flags and ``-Xptxas -v``, all at once, into
    ``build/torch_ext/inspect/``, and read its SASS with the toolkit's
    ``cuobjdump``. -> {source: {"rc": nvcc's exit code, "ptxas": its lines
    on registers, spills and errors, "spill_bytes": the bytes of spill
    stores and loads over its kernels, "mma": {kernel: number of HMMA and
    HGMMA instructions} or None where the toolkit has no cuobjdump}}."""
    from torch.utils.cpp_extension import CUDA_HOME

    tools = Path(CUDA_HOME or "/usr/local/cuda") / "bin"
    out_dir = BUILD_DIR / "inspect"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {src: subprocess.Popen([str(tools / "nvcc"), *CUDA_FLAGS, "-Xptxas", "-v", "-c",
                                    str(CSRC / src), "-o", str(out_dir / f"{src}.o")],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src in sources}
    result = {}
    for src, proc in procs.items():
        _, err = proc.communicate()
        lines = []
        for ln in err.splitlines():
            head = re.search(r"Function properties for (\S+)", ln)
            if head:
                lines.append(_demangle(tools, head.group(1)))
            elif "registers" in ln or "spill" in ln or "rror" in ln:
                lines.append(ln.strip())
        mma = None
        if proc.returncode == 0 and (tools / "cuobjdump").exists():
            sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(out_dir / f"{src}.o")],
                                  capture_output=True, text=True).stdout
            mma, name = {}, None
            for ln in sass.splitlines():
                head = re.search(r"Function : (\S+)", ln)
                if head:
                    name = _demangle(tools, head.group(1))
                    mma[name] = 0
                elif name is not None and re.search(r"\bHG?MMA\.", ln):
                    mma[name] += 1
        spill_bytes = sum(int(v) for ln in lines for v in re.findall(r"(\d+) bytes spill", ln))
        result[src] = {"rc": proc.returncode, "ptxas": lines, "spill_bytes": spill_bytes, "mma": mma}
    return result


def _demangle(tools: Path, name: str) -> str:
    filt = tools / "cu++filt"
    if not filt.exists():
        return name
    return subprocess.run([str(filt), name], capture_output=True, text=True).stdout.strip() or name

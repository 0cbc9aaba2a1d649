"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface, loaded with :mod:`ctypes`.  The library lands in
``kernels/_build/<hash>/`` (git-ignored), where ``<hash>`` covers the
sources and the flags, so an edited source rebuilds and an unchanged one
loads the existing library.  Nothing is built when this module is imported:
:func:`library` builds on first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("gram.cu", "tall_apply.cu", "tiled_matmul.cu", "flash_attention.cu",
           "ssd_scan.cu", "zipup_block.cu")
HEADERS = ("mma_bf16.cuh",)     # included by the flash and SSD sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "repro_gram_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    "repro_gram_c64": (_P, _P, _P, _I, _I, _I, _I, _P),
    "repro_gram_splits": (_I, _I, _I),
    "repro_tall_apply_f32": (_P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _P),
    "repro_tall_apply_c64": (_P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _I,
                             _I, _P),
    "repro_tiled_matmul_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_tiled_matmul_splits": (_I, _I, _I, _I),
    "repro_flash_attention": (_P, _P, _P, _P) + (_I,) * 8 + (_L,) * 12 + (_P,),
    "repro_ssd_scan": (_P,) * 6 + (_I,) * 5 + (_L,) * 8 + (_P,),
    "repro_ssd_scan_bf16": (_P,) * 8 + (_I,) * 5 + (_L,) * 8 + (_P,),
    "repro_ssd_scan_smem_bytes": (_I, _I, _I),
    "repro_ssd_chunked_smem_bytes": (_I, _I, _I),
    # the shapes and strides in one int64 host array (csrc/zipup_block.cu)
    "repro_zipup_pair": (_P, _P, _P, _P, _I, _P),
    "repro_zipup_chain": (_P, _P, _P, _P, _P, _I, _P),
}

# Shared memory one block may use on the H100 (bytes, dynamic).
MAX_SMEM_BYTES = 232448
_lib = None
# one build and one load, whichever thread launches first
_LIB_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the repro_torch CUDA kernels")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile every source in parallel and link; returns the library path.
    Raises RuntimeError with the compiler's output when a step fails."""
    lib = library_path()
    if lib.exists():
        return lib
    out_dir = lib.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    link = subprocess.run([nvcc, "-shared", "-o", tmp,
                           *(str(obj) for _, obj, _ in procs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """The compiler output (``-Xptxas -v``: registers, spills) of the build."""
    path = library_path().parent / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; threads that
    call at once wait for the one build)."""
    global _lib
    if _lib is not None:
        return _lib
    with _LIB_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's number of streaming multiprocessors (the kernels plan
    their grids from it)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    """The raw pointer of the current CUDA stream on ``device`` (PyTorch's
    own accessor: building a ``torch.cuda.Stream`` object costs several
    microseconds a launch)."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def card_count() -> int:
    """The visible CUDA devices (fixed for the life of the process)."""
    import torch
    return torch.cuda.device_count()


def launch(fn, device, *args) -> int:
    """Call the library's launcher ``fn`` with ``args`` and the current
    stream of ``device`` as its last argument, ``device`` being the host
    thread's current CUDA device during the call: a launch runs in the
    current device's context, so an operand on another card than the
    current one must switch it, and switch it back after.  With one card
    there is nothing to switch and nothing is queried.  The current
    device and stream are the calling thread's own (PyTorch keeps the
    current stream per thread), so a worker thread of
    :mod:`repro_torch.core.spmd` launches on its own stream and card.
    Returns ``fn``'s CUDA error code."""
    import torch
    if card_count() == 1:
        return fn(*args, torch._C._cuda_getCurrentRawStream(0))
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    torch._C._cuda_setDevice(index)
    try:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    finally:
        torch._C._cuda_setDevice(current)


def f32_matrix(x, name: str, *, allow_transposed: bool = False):
    """Validate a kernel operand on the card: a 2-D, non-empty f32 or bf16
    tensor (bf16 is widened to f32, exactly), row-major contiguous — or,
    with ``allow_transposed``, the transpose of a row-major matrix.
    Returns ``(tensor, transposed)``; raises on anything else."""
    import torch
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype == torch.bfloat16:
        x = x.float()
    elif x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.is_contiguous():
        return x, False
    if allow_transposed and x.t().is_contiguous():
        return x, True
    raise ValueError(f"{name}: expected a row-major contiguous matrix"
                     + (" or its transpose" if allow_transposed else "")
                     + f", got strides {x.stride()}")

"""Build, load and launch the CUDA kernels of ``csrc/aged_kernels.cu``.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library is keyed on a hash of the source and the flags and lives under
``build/kernels/`` at the repository root (git-ignored); a build writes to
a temporary name and renames it, so concurrent first uses are safe.  The
launch helpers run on PyTorch's current stream, do not synchronise, and
raise if the launch was refused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).with_name("csrc") / "aged_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GEMM_PLAIN, GEMM_UPSET, GEMM_UPSET_DEQUANT = 0, 1, 2

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def library_path() -> Path:
    """Path of the built library for the current source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"aged_kernels_{digest}.so"


def build() -> dict:
    """Compile the kernels if no library for this source exists yet.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's ptxas
    report (registers, shared memory, spills) of the build that made it.
    """
    path = library_path()
    log = path.with_suffix(".log")
    t0 = time.perf_counter()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "log": log.read_text() if log.exists() else ""}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.aged_int8_gemm.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                           ctypes.c_uint32, ctypes.c_float,
                                           ci, ci, ci, vp]
            lib.aged_int8_gemm.restype = ci
            lib.aged_bitflip.argtypes = [vp, vp, vp, ctypes.c_float, vp,
                                         ctypes.c_longlong, vp]
            lib.aged_bitflip.restype = ci
            lib.aged_error_string.argtypes = [ci]
            lib.aged_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(code: int, what: str) -> None:
    if code:
        msg = library().aged_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
                mode: int, xs=None, ws=None, seed: int = 0, q: float = 0.0,
                lbm: int = 1, lbn: int = 1, grid_n: int = 1) -> None:
    """int8 GEMM into ``out`` (int32, or float32 for the dequant mode)."""
    M, K = a.shape
    N = b.shape[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = library().aged_int8_gemm(
            _ptr(a), _ptr(b), _ptr(xs), _ptr(ws), _ptr(out), M, N, K, mode,
            int(seed) & 0xFFFFFFFF, float(q), lbm, lbn, grid_n, stream)
    _check(code, "int8 GEMM")


def launch_bitflip(x, u, pos, q: float, out) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = library().aged_bitflip(_ptr(x), _ptr(u), _ptr(pos), float(q),
                                      _ptr(out), x.numel(), stream)
    _check(code, "bitflip")

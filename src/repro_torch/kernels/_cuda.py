"""Build, load and launch the CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library is keyed on a hash of every file under ``csrc/`` and the flags and
lives under ``build/kernels/`` at the repository root (git-ignored); a
build writes to a temporary name and renames it, so concurrent first uses
are safe.  The launch helpers run on PyTorch's current stream, do not
synchronise, and raise if the launch was refused.

The int8 GEMM runs on a plan made here (:func:`gemm_plan`): the fast
tensor-core path with split-K for shapes it takes, the generic masked path
for the rest.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
SOURCE = CSRC / "aged_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GEMM_PLAIN, GEMM_UPSET, GEMM_UPSET_DEQUANT = 0, 1, 2
FAST, GENERIC = "fast", "generic"
_PATH_CODE = {GENERIC: 0, FAST: 1}
FAST_BK = 128        # K depth of one stage of the fast path's copy ring
GENERIC_TILE = (32, 128, 64)   # (bm, bn, bk) of the generic path

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def library_path() -> Path:
    """Path of the built library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(CSRC)).encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"aged_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels if no library for these sources exists yet.

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
            vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.aged_int8_gemm.argtypes = [
                vp, vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_uint32,
                ctypes.c_float, ci, ci, ci,        # ... lbm, lbn, grid_n
                ci, ci, ci, ci,                    # path, bm, bn, splits
                vp, ll, vp, ll,                    # workspace and tickets
                vp]
            lib.aged_int8_gemm.restype = ci
            lib.aged_bitflip.argtypes = [vp, vp, vp, ctypes.c_float, vp, ll,
                                         vp]
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


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How one ``(M, K) @ (K, N)`` int8 GEMM is launched.

    ``path`` is :data:`FAST` (tensor cores, copy ring, split-K) or
    :data:`GENERIC`; the CTA tile is ``bm x bn``, ``bk`` the K depth of a
    stage, ``splits`` the number of K ranges (grid z).
    """
    path: str
    M: int
    N: int
    K: int
    bm: int
    bn: int
    bk: int
    splits: int

    @property
    def tiles(self) -> int:
        return -(-self.M // self.bm) * -(-self.N // self.bn)

    @property
    def grid(self) -> tuple:
        return (-(-self.N // self.bn), -(-self.M // self.bm), self.splits)

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    def k_ranges(self) -> list:
        """``[k0, k1)`` of each split, as the kernel cuts them: split ``s``
        takes stages ``[s * nb // splits, (s + 1) * nb // splits)`` of the
        ``nb = ceil(K / bk)`` stages."""
        nb = -(-self.K // self.bk)
        return [(min(s * nb // self.splits * self.bk, self.K),
                 min((s + 1) * nb // self.splits * self.bk, self.K))
                for s in range(self.splits)]

    @property
    def workspace_words(self) -> int:
        """int32 words of split partials (0 without a split)."""
        return self.tiles * self.splits * self.bm * self.bn \
            if self.splits > 1 else 0

    @property
    def n_tickets(self) -> int:
        return self.tiles if self.splits > 1 else 0



@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, n_sms: int, *,
              aligned: bool = True) -> GemmPlan:
    """The launch plan of an ``(M, K) @ (K, N)`` int8 GEMM on ``n_sms`` SMs.

    The fast path takes K and N multiples of 16 with 16-byte aligned
    operands.  Its M tile is the smallest of 16/32/64 rows that holds M, so
    decode (M = 2) computes 14 dead rows, not 30; its N tile is 128 columns,
    or 64 when 128-column tiles would not give every SM one.  K is then
    split until the grid holds at least one CTA per SM (as far as there
    are stages to split): the weight-streaming calls are bound by the bytes
    of ``b``, and an idle SM is bandwidth left unused, while each split
    costs a partial's round trip and a ticket.
    """
    if not (aligned and K % 16 == 0 and N % 16 == 0):
        bm, bn, bk = GENERIC_TILE
        return GemmPlan(GENERIC, M, N, K, bm, bn, bk, 1)
    bm = 16 if M <= 16 else 32 if M <= 32 else 64
    tiles_m = -(-M // bm)
    bn = 128 if tiles_m * -(-N // 128) >= n_sms else 64
    tiles = tiles_m * -(-N // bn)
    kblocks = -(-K // FAST_BK)
    splits = max(1, min(kblocks, -(-n_sms // tiles)))
    return GemmPlan(FAST, M, N, K, bm, bn, FAST_BK, splits)


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_workspaces: dict = {}


def _workspace(device: torch.device, stream: int, plan: GemmPlan):
    """Split partials and zeroed tickets, one pair per device and stream,
    grown to the largest plan seen.  The kernel leaves every ticket at 0,
    so a reused pair needs no memset; calls on one stream are ordered, so
    they never share it at once."""
    key = (device.index, stream)
    parts, tickets = _workspaces.get(key, (None, None))
    if parts is None or parts.numel() < plan.workspace_words:
        parts = torch.empty(max(plan.workspace_words, 4), dtype=torch.int32,
                            device=device)
    if tickets is None or tickets.numel() < plan.n_tickets:
        tickets = torch.zeros(max(plan.n_tickets, 1), dtype=torch.int32,
                              device=device)
    _workspaces[key] = (parts, tickets)
    return parts, tickets


def launch_gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
                mode: int, xs=None, ws=None, seed: int = 0, q: float = 0.0,
                lbm: int = 1, lbn: int = 1, grid_n: int = 1) -> str:
    """int8 GEMM into ``out`` (int32, or float32 for the dequant mode), on
    :func:`gemm_plan`'s plan.

    Returns the path the plan took (:data:`FAST` or :data:`GENERIC`).
    """
    M, K = a.shape
    N = b.shape[1]
    aligned = (a.data_ptr() | b.data_ptr() | out.data_ptr()) % 16 == 0
    with torch.cuda.device(a.device):
        plan = gemm_plan(M, N, K, _n_sms(a.device.index), aligned=aligned)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        parts = tickets = None
        if plan.splits > 1:
            parts, tickets = _workspace(a.device, stream, plan)
        code = library().aged_int8_gemm(
            _ptr(a), _ptr(b), _ptr(xs), _ptr(ws), _ptr(out), M, N, K, mode,
            int(seed) & 0xFFFFFFFF, float(q), lbm, lbn, grid_n,
            _PATH_CODE[plan.path], plan.bm, plan.bn, plan.splits,
            _ptr(parts), 0 if parts is None else parts.numel(),
            _ptr(tickets), 0 if tickets is None else tickets.numel(), stream)
    _check(code, "int8 GEMM")
    return plan.path


def launch_bitflip(x, u, pos, q: float, out) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = library().aged_bitflip(_ptr(x), _ptr(u), _ptr(pos), float(q),
                                      _ptr(out), x.numel(), stream)
    _check(code, "bitflip")

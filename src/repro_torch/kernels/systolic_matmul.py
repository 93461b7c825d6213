"""int8 x int8 -> int32 systolic-array matmul, on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/systolic_matmul.py::
systolic_matmul`` (body ``_matmul_kernel``): the int32 accumulator stays
resident across the whole K reduction, as the paper's 256x256 array keeps
its partial sums in the PE grid.  On the card it is the same CUDA main loop
as the fused kernel (``csrc/aged_kernels.cu``, mode 0) with an int32 store
epilogue; like it, it is bound by the bytes of ``b`` at the serve path's
M = 2 / 32, and takes the fast path (split-K over all SMs, an asynchronous
copy ring, int8 tensor cores) where K and N are multiples of 16, the
generic masked path elsewhere (``launches_by_path`` counts both).  The
int32 accumulator stays in registers within a split; splits add exactly.
It backs the three-pass route (``use_fused_kernel=False``).
"""
from __future__ import annotations

import torch

from . import _cuda
from .fused_aged_matmul import _check_int8_operands


def systolic_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b (K, N) int8 -> (M, N) int32``, any shapes.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    from . import ref
    _check_int8_operands(a, b)
    if a.device.type == "cpu":
        return ref.systolic_matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    if out.numel() == 0:
        return out
    path = _cuda.launch_gemm(a, b, out, mode=_cuda.GEMM_PLAIN)
    systolic_matmul.launches += 1
    systolic_matmul.launches_by_path[path] += 1
    return out


systolic_matmul.launches = 0
systolic_matmul.launches_by_path = {_cuda.FAST: 0, _cuda.GENERIC: 0}

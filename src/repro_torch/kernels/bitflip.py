"""BER-parameterised accumulator bit-error injection, on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/bitflip.py::bitflip_words``
(body ``_bitflip_kernel``): an elementwise ``where(u < q, x ^ (1 << pos),
x)`` over ``(R, 128)`` int32 words, with the uniforms ``u`` and positions
``pos`` drawn by threefry outside the kernel
(:func:`repro_torch.kernels.ops.make_flip_randoms`), so the plain version
consumes the same randomness.  The CUDA kernel
(``csrc/aged_kernels.cu::bitflip_kernel``, one word per thread) is bound by
its 16 bytes of traffic per word; it carries the qkt/sv activation domains
on the kernel route and every faulted matmul on the three-pass route.
"""
from __future__ import annotations

import torch

from . import _cuda


def bitflip_words(x: torch.Tensor, u: torch.Tensor, pos: torch.Tensor,
                  q: float, *, block_rows: int = 256) -> torch.Tensor:
    """Flip one random bit per word where ``u < q``.

    ``x`` int32 ``(R, 128)`` with ``R`` a multiple of ``block_rows``; ``u``
    float32 and ``pos`` int32 of the same shape; ``q`` the word-upset
    probability.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.
    """
    from . import ref
    R, C = x.shape
    if C != 128 or R % block_rows:
        raise ValueError(f"need (R, 128) words with R % {block_rows} == 0, "
                         f"got {tuple(x.shape)}")
    if (x.dtype, u.dtype, pos.dtype) != (torch.int32, torch.float32,
                                         torch.int32):
        raise TypeError(f"need int32/float32/int32, got {x.dtype}/{u.dtype}/"
                        f"{pos.dtype}")
    if u.shape != x.shape or pos.shape != x.shape:
        raise ValueError("x, u and pos must have one shape")
    if not (x.device == u.device == pos.device):
        raise ValueError("x, u and pos must be on one device")
    if x.device.type == "cpu":
        return ref.bitflip_words_ref(x, u, pos, q)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not (x.is_contiguous() and u.is_contiguous() and pos.is_contiguous()):
        raise ValueError("x, u and pos must be contiguous")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _cuda.launch_bitflip(x, u, pos, q, out)
    bitflip_words.launches += 1
    return out


bitflip_words.launches = 0

"""BER-parameterised accumulator bit-error injection, on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/bitflip.py::bitflip_words``
(body ``_bitflip_kernel``): an elementwise ``where(u < q, x ^ (1 << pos),
x)`` over int32 words.  The reference draws the uniforms ``u`` and the
positions ``pos`` with threefry outside the kernel, over a zero-padded
``(rows_pad, 128)`` layout.  Two modes of one CUDA kernel pass
(``csrc/aged_kernels.cu``):

* :func:`bitflip_words` (``bitflip_kernel``) reads ``u`` and ``pos`` from
  device memory: the kernel's counterpart signature for signature.
* :func:`bitflip_draw` (``bitflip_draw_kernel``) draws them itself, in
  registers, from four key words: word ``i`` of a draw depends on the key
  and ``i`` alone, so the flat words of ``x`` get exactly the reference's
  draws with no padding.  :func:`repro_torch.kernels.ops.inject_bitflips`
  launches it once per injection (the qkt/sv domains on the kernel route,
  every faulted matmul on the three-pass route).  It is bound by its
  integer work (up to two threefry hashes a word), not by its 8 bytes a
  word.
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


def bitflip_draw(x: torch.Tensor, key_words, q: float) -> torch.Tensor:
    """Flip bit ``pos_i`` of word ``i`` of ``x`` where ``u_i < q``, with
    ``u_i`` word ``i`` of a uniform draw keyed ``key_words[:2]`` and
    ``pos_i`` word ``i`` of a bits draw keyed ``key_words[2:]``, ``& 31``.

    ``x`` contiguous int32 of any shape (row-major word order); the four
    key words are uint32 Python ints
    (:func:`repro_torch.kernels.ops.flip_key_words`).  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    from . import ref
    if x.dtype != torch.int32:
        raise TypeError(f"need int32 words, got {x.dtype}")
    if len(key_words) != 4:
        raise ValueError(f"need four key words, got {len(key_words)}")
    if x.device.type == "cpu":
        return ref.bitflip_draw_ref(x, key_words, q)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _cuda.launch_bitflip_draw(x, key_words, q, out)
    bitflip_draw.launches += 1
    return out


bitflip_words.launches = 0
bitflip_draw.launches = 0

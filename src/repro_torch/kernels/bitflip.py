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
* :func:`bitflip_draw_lanes` is its lane mode: ``(L, n)`` words, lane
  ``l`` drawing word ``i`` of its own words from its own keys at its own
  ``q`` — the reference's injection under ``jax.vmap`` — in one launch
  for up to :data:`repro_torch.kernels._cuda.MAX_LANES` lanes.
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


def _draw(counter, x, key_words, qs) -> torch.Tensor:
    """The draw-mode kernel on the card over ``len(qs)`` lanes of ``x``,
    :data:`_cuda.MAX_LANES` lanes a launch, each counted on ``counter``."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    flat, flat_out = x.reshape(len(qs), -1), out.reshape(len(qs), -1)
    for l0 in range(0, len(qs), _cuda.MAX_LANES):
        l1 = min(len(qs), l0 + _cuda.MAX_LANES)
        _cuda.launch_bitflip_draw(flat[l0:l1], key_words[l0:l1], qs[l0:l1],
                                  flat_out[l0:l1])
        counter.launches += 1
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
    return _draw(bitflip_draw, x, [tuple(key_words)], [q])


def bitflip_draw_lanes(x: torch.Tensor, key_words, qs) -> torch.Tensor:
    """Lane mode of :func:`bitflip_draw`: ``x`` is int32 ``(L, ...)``, and
    lane ``l`` flips its words ``x[l]`` (row-major, indexed from 0 within
    the lane) with the four key words ``key_words[l]`` at ``qs[l]``.
    CPU tensors take the plain lane version; CUDA tensors launch the
    kernel once per :data:`repro_torch.kernels._cuda.MAX_LANES` lanes."""
    from . import ref
    if x.dtype != torch.int32:
        raise TypeError(f"need int32 words, got {x.dtype}")
    key_words, qs = [tuple(k) for k in key_words], tuple(qs)
    if x.dim() < 1 or len(qs) != x.shape[0] or len(key_words) != len(qs) \
            or any(len(k) != 4 for k in key_words):
        raise ValueError(f"need four key words and a q for each of the "
                         f"{x.shape[0] if x.dim() else 0} lanes of x")
    if x.device.type == "cpu":
        return ref.bitflip_draw_lanes_ref(x, key_words, qs)
    return _draw(bitflip_draw_lanes, x, key_words, qs)


bitflip_words.launches = 0
bitflip_draw.launches = 0
bitflip_draw_lanes.launches = 0

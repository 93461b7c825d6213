"""Counter-stream accumulator upsets under per-shard BERs, on Hopper.

The reference injects the qkt/sv accumulators of mesh serving with
``repro/kernels/ops.py::inject_bitflips_sharded``: a pure-jnp pass that
splits the accumulator into shards (by column, or by the flattened heads
of a leading axis), and draws, for each shard's block, the fused kernel's
counter stream over the block's own tile grid at the shard's BER, from the
seed ``fold_seed(seed, s)``.  :func:`counter_upset_shards` is that pass as
one elementwise CUDA launch (``counter_upset_kernel`` in
``csrc/aged_kernels.cu``, sharing the GEMM's ``counter_bits`` and
``flip_word``) with its shard tables passed by value; its plain version is
:func:`repro_torch.kernels.ref.counter_upset_shards_ref`, which
:func:`repro_torch.kernels.ops.inject_bitflips_sharded` runs.
"""
from __future__ import annotations

import torch

from . import _cuda


def counter_upset_shards(x: torch.Tensor, qs, seeds, tables) -> torch.Tensor:
    """Upset ``x`` (int32, viewed as ``(R, D)`` with its last axis the
    columns) shard by shard: shard ``s`` at upset probability ``qs[s]``
    from the stream of ``seeds[s]``, over ``tables`` (the split, the
    shards' bounds and their blocks' tiles, from
    :func:`repro_torch.kernels.ops.shard_upset_tables`).  CPU tensors take
    the plain version; CUDA tensors launch the kernel once."""
    from . import ref
    if x.dtype != torch.int32:
        raise TypeError(f"int32 words only, got {x.dtype}")
    S = len(qs)
    if not 1 <= S <= _cuda.MAX_LANES or len(seeds) != S \
            or len(tables["bounds"]) != S + 1:
        raise ValueError(f"{S} shards (1 to {_cuda.MAX_LANES}) need as many "
                         f"seeds and {S + 1} bounds")
    if x.device.type == "cpu":
        return ref.counter_upset_shards_ref(x, qs, seeds, tables)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _cuda.launch_counter_upset(
        x, out, qs, seeds, tables["bounds"], tables["bms"], tables["bns"],
        tables["grids"], by_row=tables["by_row"], mid=tables["mid"],
        n_ax=tables["n_ax"])
    counter_upset_shards.launches += 1
    return out


counter_upset_shards.launches = 0

"""Hand-written Hopper kernels of the port and their wrappers.

* :mod:`fused_aged_matmul` — int8 GEMM + accumulator upsets + dequant in
  one pass (the serve hot path), with the counter-stream functions, and
  its lane mode (several devices' rows against one weight).
  and its shard mode (one device's output-column blocks, each at its own
  BER and stream: mesh serving).
* :mod:`systolic_matmul`   — int8 x int8 -> int32 GEMM (three-pass route).
* :mod:`bitflip`           — accumulator bit-flip pass, on given randoms
  (``bitflip_words``) or drawing its own (``bitflip_draw``, and its lane
  mode ``bitflip_draw_lanes``).
* :mod:`counter_upset`     — counter-stream upsets of an accumulator split
  into shards (the qkt/sv domains under per-shard BERs).
* :mod:`ops`               — shape handling, routes, quantisation.
* :mod:`ref`               — plain PyTorch versions of the kernels.

Each wrapper counts its launches in a ``launches`` attribute, and the
int8 GEMM wrappers also per path in ``launches_by_path``;
:func:`launch_counts`, :func:`launch_counts_by_path` and
:func:`reset_launch_counts` read and clear them.
"""
from __future__ import annotations

KERNEL_NAMES = ("fused_aged_matmul", "fused_aged_matmul_lanes",
                "fused_aged_matmul_shards", "bitflip_words", "bitflip_draw",
                "bitflip_draw_lanes", "counter_upset_shards",
                "systolic_matmul")


def _wrappers():
    from .bitflip import bitflip_draw, bitflip_draw_lanes, bitflip_words
    from .counter_upset import counter_upset_shards
    from .fused_aged_matmul import (fused_aged_matmul, fused_aged_matmul_lanes,
                                    fused_aged_matmul_shards)
    from .systolic_matmul import systolic_matmul
    return {"fused_aged_matmul": fused_aged_matmul,
            "fused_aged_matmul_lanes": fused_aged_matmul_lanes,
            "fused_aged_matmul_shards": fused_aged_matmul_shards,
            "bitflip_words": bitflip_words,
            "bitflip_draw": bitflip_draw,
            "bitflip_draw_lanes": bitflip_draw_lanes,
            "counter_upset_shards": counter_upset_shards,
            "systolic_matmul": systolic_matmul}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def launch_counts_by_path() -> dict:
    """GEMM launches per wrapper and path (``fast`` / ``generic``)."""
    return {name: dict(fn.launches_by_path)
            for name, fn in _wrappers().items()
            if hasattr(fn, "launches_by_path")}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_path"):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)

"""Hand-written Hopper kernels of the port and their wrappers.

* :mod:`fused_aged_matmul` — int8 GEMM + accumulator upsets + dequant in
  one pass (the serve hot path), with the counter-stream functions.
* :mod:`systolic_matmul`   — int8 x int8 -> int32 GEMM (three-pass route).
* :mod:`bitflip`           — accumulator bit-flip pass over (R, 128) words.
* :mod:`ops`               — shape handling, routes, quantisation.
* :mod:`ref`               — plain PyTorch versions of the three kernels.

Each wrapper counts its launches in a ``launches`` attribute;
:func:`launch_counts` / :func:`reset_launch_counts` read and clear them.
"""
from __future__ import annotations

KERNEL_NAMES = ("fused_aged_matmul", "bitflip_words", "systolic_matmul")


def _wrappers():
    from .bitflip import bitflip_words
    from .fused_aged_matmul import fused_aged_matmul
    from .systolic_matmul import systolic_matmul
    return {"fused_aged_matmul": fused_aged_matmul,
            "bitflip_words": bitflip_words,
            "systolic_matmul": systolic_matmul}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0

"""Where the port's tensors live: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    Raises when CUDA is requested (the default) but no CUDA device exists:
    the port never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return dev


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as one correctly rounded division on every device.

    PyTorch's CUDA division by a Python number multiplies by the rounded
    reciprocal instead, which can differ from the reference's division in
    the last bit (and then, e.g., in an int8 quantisation step); a 0-d
    tensor divisor keeps the true division.
    """
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)

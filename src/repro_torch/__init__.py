"""PyTorch/CUDA port of the aging-aware AVS reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage and module names (``core``, ``kernels``, ``models``, ``serve``,
``configs``, ``data``, ``obs``) and is held against it by the
``tests/test_torch_*.py`` parity tests.  It imports ``torch`` only — never
``jax`` and nothing of ``repro``.

Every entry point runs on ``"cuda"`` unless the caller passes
``device="cpu"``; without a CUDA device and without that request it raises
(:func:`repro_torch.device.resolve_device`).  The three Pallas TPU kernels
of the reference are hand-written CUDA kernels for Hopper
(``kernels/csrc/aged_kernels.cu``), built at first use.
"""

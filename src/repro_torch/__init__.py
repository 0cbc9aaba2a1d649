"""PyTorch/CUDA port of the PEPS library in :mod:`repro` (JAX reference).

The module layout mirrors ``repro``: ``repro_torch.core.peps`` is the
counterpart of ``repro.core.peps`` and so on.  The port never imports JAX or
the reference package; hand-written Hopper kernels live under
``repro_torch/kernels/csrc`` and are built with ``nvcc`` on first use.

Entry points that create tensors default to the CUDA device and raise when
none is present unless the caller passes ``device="cpu"`` explicitly.
"""

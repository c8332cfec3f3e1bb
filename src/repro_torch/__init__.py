"""PyTorch/CUDA port of the RF-TCA package ``repro`` (one NVIDIA H100).

Mirrors the reference layout module for module (``repro_torch.core.rf_tca``
<-> ``repro.core.rf_tca``).  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; on a CUDA tensor every kernel wrapper
launches its hand-written kernel (``kernels/csrc``) or raises, and on a CPU
tensor it runs the kernel's plain PyTorch version.

Submodules are imported by name (``repro_torch.core.rf_tca``); this package
re-exports nothing, so no function shadows a submodule's name.
"""

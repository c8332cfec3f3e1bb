"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

- prng:            threefry-2x32 seed-fused Omega draws (K4)
- rff:             fused RFF feature map, FFMA product + cos/sin epilogue (K1)
- rff_gram_stream: seed-fused streamed Gram/moment accumulation (K5, K6)
- ops:             the public wrappers; ref: the dense oracles

Kernels are built by ``_build`` with ``nvcc`` at first use on the card.
"""

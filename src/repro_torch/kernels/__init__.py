"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

- prng:            threefry-2x32 seed-fused Omega draws (K4)
- rff:             RFF feature map, FFMA product + cos/sin epilogue, Omega an
                   operand (K1) or drawn in the kernel (K7)
- rff_gram_stream: streamed Gram/moment accumulation, Omega an operand (K2, K3)
                   or drawn in the kernel (K5, K6)
- centered_gram:   Sigma H Sigma^T from a materialized Sigma (K8)
- segment_reduce:  weighted segment sums of the two-tier fleet merges (K9)
- quantize:        stochastic-rounding fake-quant of the wire codecs (K10)
- flash_attention: GQA online-softmax attention, causal / window (K11), its
                   backward (K11b) and the autograd Function joining them
- ops:             the public wrappers; ref: the dense oracles

Kernels are built by ``_build`` with ``nvcc`` at first use on the card.
"""

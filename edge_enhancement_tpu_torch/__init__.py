"""edge_enhancement_tpu_torch — the PyTorch/CUDA port of edge_enhancement_tpu.

The JAX package beside it is the reference: every module here mirrors a
module of the same path there and is held against it by the tests
(tests/test_torch_*.py). This package imports torch and never jax.

Every Pallas TPU kernel of the JAX package is a hand-written CUDA kernel
for Hopper here: the edge-enhancement front-end's (ops/cuda/ee_fused.py,
csrc/ee_fused.cu) and the 3x3 GEMM-conv (ops/cuda/gemm_conv.py,
csrc/gemm_conv.cu), built with nvcc at first use. Each kernel keeps a
plain PyTorch version beside it, which the CPU path and the tests use.
The package imports nothing of the JAX package either.
"""

__version__ = "0.1.0"

"""edge_enhancement_tpu_torch — the PyTorch/CUDA port of edge_enhancement_tpu.

The JAX package beside it is the reference: every module here mirrors a
module of the same path there and is held against it by the tests
(tests/test_torch_*.py). This package imports torch and never jax.

The fused edge-enhancement front-end runs as hand-written CUDA kernels for
Hopper (ops/cuda/ee_fused.py, csrc/ee_fused.cu), built with nvcc at first
use. Each kernel keeps a plain PyTorch version beside it, which the CPU
path and the tests use.
"""

__version__ = "0.1.0"

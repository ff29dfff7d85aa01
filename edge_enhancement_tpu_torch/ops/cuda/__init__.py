"""Hand-written CUDA kernels (sources in edge_enhancement_tpu_torch/csrc)."""

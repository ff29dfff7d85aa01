"""Differentiable edge/defense ops, NHWC at the public functions as in
edge_enhancement_tpu.ops. Submodules are imported explicitly."""

"""See the module of the same path in edge_enhancement_tpu."""

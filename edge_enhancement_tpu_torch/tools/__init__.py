"""Command-line tools of the port, run as python -m edge_enhancement_tpu_torch.tools.<name>."""

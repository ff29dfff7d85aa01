"""python -m edge_enhancement_tpu_torch.train — see train/driver.py."""

from .driver import main

main()

"""Imported first by every tests/test_torch_*.py: CPU torch on one thread.

The suite runs under pytest-xdist, several worker processes on one host,
and CPU torch's default of one OpenMP thread per core makes each worker's
threads compete with the others' (a port test file that takes 34 s alone
took 457 s with six workers so). One thread a worker keeps each worker's
time its own. Inter-op threads are left alone: setting them raises once
inter-op work has started in the process. The port's JPEG decoder
(data/native.py) runs an OpenMP team of its own, on the loader's lookahead
thread, which torch's setting does not reach: it is held to one thread
too. The module imports no JAX, so the card-only tests
(tests/test_torch_cuda.py) can import it too.
"""

import torch

from edge_enhancement_tpu_torch.data import native

torch.set_num_threads(1)
native.set_num_threads(1)

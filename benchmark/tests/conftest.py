"""The benchmark's own tests, run from the checkout's root:

    python -m pytest benchmark/tests -q            # on the CPU
    python -m pytest benchmark/tests -q -m cuda    # on a card: the controls

CPU torch on two threads; a session's tiny copy of the benchmark."""

import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from benchmark.tests import tiny
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))

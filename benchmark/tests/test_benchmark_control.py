"""The controls, on a card at each cell's own size: the program passes its
limits, and the reference put in the program's place in the precision
below the configuration's (TF32 for float32) fails at least one of them. benchmark/calibrate.py makes the readings that the
limits were set from; this is one seed of each.

    python -m pytest benchmark/tests/test_benchmark_control.py -q -m cuda"""

import pytest

from benchmark.lib import spec

CELLS = ("tinyin_r18.pgd10_at_graph",)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    import os

    from benchmark import calibrate
    limits = spec.load_json(os.path.join(spec.BENCH_DIR, "limits", cell + ".json"))["limits"]
    rows = calibrate.readings(cell, [4500000001], [4500000002], [], device=card)
    (_, _, prog), (_, _, ctrl) = rows
    assert all(prog[n] <= v for n, v in limits.items()), prog
    assert any(ctrl[n] > v for n, v in limits.items()), ctrl

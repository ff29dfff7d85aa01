"""The reference against the program at test sizes on the CPU, where both
run plain PyTorch (the kernels' plain versions): one set-up of each
training entry (its three steps), every number the cell can compare."""

import pytest
import torch

from benchmark.lib import compare, spec
from benchmark.tests.tiny import TINY


@pytest.mark.parametrize("real", sorted(TINY))
def test_reference_follows_the_program(real, tiny_root):
    import os
    cell = spec.find_cell(TINY[real], root=tiny_root,
                          bench_dir=os.path.join(tiny_root, "benchmark"))
    a = spec.path_adapter(cell.traffic["path"], cell.bench_dir).Path(cell, 2024, torch.device("cpu"))
    a.setup()
    for _ in range(4):
        a.unit()
    record = a.program_record()
    a.release()
    numbers = compare.train_numbers(record, a.reference_record(follow=record))
    assert numbers["loss_gap"] == 0.0
    assert numbers["grad_gap"] < 1e-6
    assert numbers["change_gap"] < 1e-6
    assert numbers["start_gap"] == 0.0
    assert numbers["flip_share"] < 1e-3
    for c in a.judge(record):
        assert c.ok, c


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; import benchmark.reference.steps, benchmark.reference.resnet; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('edge_enhancement_tpu_torch', 'edge_enhancement_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

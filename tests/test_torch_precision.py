"""Fault F2: a float32 recipe computes in float32 on the card, as the JAX
package's does. The driver and eval.py turn TF32 off for cuDNN and
matmuls (`train/driver.py::pin_precision`) and say so on the run's first
log line; the bf16 policy (`half: true`) leaves both flags as they are.
Run on the CPU, where the flags are only read back."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import os

import pytest
import torch

from torch_checkpoints import drop_written_checkpoints  # noqa: F401  (autouse)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "edge_enhancement_tpu", "configs")


@pytest.fixture
def tf32_flags():
    """cuDNN's and matmul's TF32 flags set to True, restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("entry", ["train", "eval"])
@pytest.mark.parametrize("config,float32", [
    ("tiny_imagenet/ee_at_bpda3_square.yml", True),
    ("fast_imagenet/fast_2px_phase1_ee.yml", False)])
def test_float32_recipes_compute_in_float32(tmp_path, capsys, tf32_flags, entry,
                                            config, float32):
    """A float32 recipe turns TF32 off for cuDNN and matmuls, in the driver
    and in eval.py, and says so on the run's first log line; the bf16
    policy (half: true) leaves both."""
    from edge_enhancement_tpu_torch import eval as port_eval
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(CONFIGS, config), dict(
        data="synthetic", synthetic_size=4, batch_size=2, cize=32, epochs=1,
        limit_batches=1, num_steps_1=1, device="cpu", output=str(tmp_path),
        suite="fgsm"))
    (run if entry == "train" else port_eval.run)(cfg)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    assert flags == ((False, False) if float32 else (True, True))
    first = capsys.readouterr().out.splitlines()[0]
    want = ("float32, TF32 cudnn False matmul False" if float32
            else "bf16 policy, TF32 cudnn True matmul True")
    assert first.endswith(want), first

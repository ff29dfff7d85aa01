"""The CUDA kernels K1/K2 of the fused front-end (csrc/ee_fused.cu) against
their plain PyTorch versions on the same card. Imports no jax; on a machine
with a CUDA device and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
from edge_enhancement_tpu_torch.ops.square import add_square_draws, kernel_layout

pytestmark = pytest.mark.cuda

EPS = 0.062745098039216
# K1: the edge maps agree exactly (same rounding order), the HFS products
# sum in another order: ~1e-6 on values of order 1. K2: the same sums,
# scaled by at most 1/|g| < 1/high = 3.4
FWD_TOL, BWD_TOL = 2e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _consts(square):
    return F.FusedConsts(r=8, eps=EPS, w=1.0, alpha=0.0, high=76 / 255,
                         sigma=1.0, square=square)


def _operands(shape, square, dev, seed=0):
    """x (B, C, H, W) with a constant patch (|g| = 0) and exact 0/1 pixels,
    the kernel-layout square draws, and a cotangent u."""
    b, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    x[:, :, 2:h // 3, 2:w // 3] = 0.5
    x[0, :, h // 2:, : w // 4] = 1.0
    x[-1, :, h // 2:, w // 2:] = 0.0
    x = torch.from_numpy(x).to(dev)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    st = sqd = None
    if square:
        gen = torch.Generator(device=dev).manual_seed(seed)
        st, sqd = kernel_layout(add_square_draws((b, h, w, c), gen), EPS)
    return x, st, sqd, u


# the square perturbation assumes square images, as the reference does
@pytest.mark.parametrize("shape,square", [((4, 3, 32, 32), True),
                                          ((4, 3, 32, 32), False),
                                          ((2, 3, 24, 40), False)])
def test_kernels_match_plain(cuda, shape, square):
    x, st, sqd, u = _operands(shape, square, cuda)
    k = _consts(square)
    out_k, y_k = F.ee_fused_fwd(x, st, sqd, k)
    out_p, y_p = F.ee_fused_fwd_plain(x, st, sqd, k)
    torch.testing.assert_close(out_k, out_p, atol=FWD_TOL, rtol=0)
    torch.testing.assert_close(y_k, y_p, atol=FWD_TOL, rtol=0)
    dx_k = F.ee_fused_bwd(u, x, st, sqd, y_p, k)
    torch.testing.assert_close(dx_k, F.ee_fused_bwd_plain(u, x, st, sqd, y_p, k),
                               atol=BWD_TOL, rtol=0)
    xa = x.clone().requires_grad_()
    (g_auto,) = torch.autograd.grad((F.ee_fused_fwd_plain(xa, st, sqd, k)[0] * u).sum(),
                                    [xa])
    torch.testing.assert_close(dx_k, g_auto, atol=BWD_TOL, rtol=0)
    assert dx_k.abs().max() > 0.1


def test_autograd_function_launches_each_kernel_once(cuda):
    x, st, sqd, u = _operands((2, 3, 32, 32), True, cuda, seed=1)
    k = _consts(True)
    F.reset_launches()
    xa = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((F.ee_fused(xa, st, sqd, k) * u).sum(), [xa])
    assert F.LAUNCHES == {"ee_fused_fwd": 1, "ee_fused_bwd": 1}
    _, y = F.ee_fused_fwd(x, st, sqd, k)
    torch.testing.assert_close(g, F.ee_fused_bwd(u, x, st, sqd, y, k), atol=0, rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    k = _consts(False)
    F.reset_launches()
    bad = [torch.zeros(1, 3, 32, 32, device=cuda, dtype=torch.float64),
           torch.zeros(1, 3, 32, 64, device=cuda)[..., ::2],     # not contiguous
           torch.zeros(1, 3, 30, 32, device=cuda),               # H % 4 != 0
           torch.zeros(1, 3, 224, 224, device=cuda)]             # above shared memory
    for x in bad:
        with pytest.raises(ValueError):
            F.ee_fused_fwd(x, None, None, k)
    x = torch.zeros(1, 3, 32, 32, device=cuda)
    with pytest.raises(ValueError):                                # missing draws
        F.ee_fused_fwd(x, None, None, _consts(True))
    assert F.LAUNCHES == {"ee_fused_fwd": 0, "ee_fused_bwd": 0}

"""The counts that the shares divide, against shapes worked by hand."""

import pytest

from benchmark.lib import flops


def test_conv_count_by_hand():
    # 3 -> 64, 7x7 stride 2 at 64 px: 32 x 32 outputs, 2 * 3 * 64 * 49 each
    ops, size = flops._conv(3, 64, 7, 2, 64)
    assert size == 32 and ops == 2 * 3 * 64 * 49 * 32 * 32


@pytest.mark.parametrize("depth,gmacs", [(18, 1.814), (50, 4.089)])
def test_resnet_forward_at_224_is_the_published_count(depth, gmacs):
    f = flops.resnet_forward(depth, 224, 1000)
    assert abs((f["convs"] + f["head"]) / 2e9 - gmacs) < 0.005
    assert f["head"] == 2 * (512 if depth == 18 else 2048) * 1000


def test_step_counts_by_what_the_step_runs():
    fwd = {"convs": 100, "stem": 10, "head": 2}
    # PGD-10 AT: ten forwards with an input gradient, one with the parameters'
    assert flops.step_flops(fwd, {"attack_iterations": 10, "train_passes": 1}) == \
        10 * 2 * 102 + (3 * 102 - 10)
    # fast-AT: one forward with an input gradient, one with the parameters'
    assert flops.step_flops(fwd, {"attack_iterations": 1, "train_passes": 1}) == \
        2 * 102 + (3 * 102 - 10)


def test_front_end_bounds_are_the_kernel_table_s():
    # PERF.md's kernel table: K1/K2 f32 at 100x3x64x64 9.39 us (operations),
    # bf16 at 256x3x128x128 K1 22.60 us and K2 30.09 us (bytes)
    f32 = flops.ee_fused_bound(100, 3, 64, 64, "float32", True)
    assert round(f32["fwd_s"] * 1e6, 2) == 9.39 and f32["fwd_by"] == "operations"
    assert round(f32["bwd_s"] * 1e6, 2) == 9.39
    bf16 = flops.ee_fused_bound(256, 3, 128, 128, "bf16", False)
    assert round(bf16["fwd_s"] * 1e6, 1) == 22.6 and bf16["fwd_by"] == "bytes"
    assert round(bf16["bwd_s"] * 1e6, 1) == 30.1 and bf16["bwd_by"] == "bytes"
    # bytes by hand: K2 reads u, x, y and writes dx (4 planes of 2 bytes),
    # the four operators in bf16 and the taps
    plane = 256 * 3 * 128 * 128 * 2
    assert bf16["bwd_s"] == pytest.approx((4 * plane + 4 * 128 * 128 * 2 + 36) / 3.35e12)

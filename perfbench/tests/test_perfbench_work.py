"""The benchmark's own work counts."""
from perfbench import work
from perfbench.tests.conftest import config


def test_macs_per_image_of_the_configurations():
    assert work.macs_per_image(config("resnet18")) == 1_660_611_328
    assert work.macs_per_image(config("alexnet")) == 599_992_000


def test_in_range_taps_skip_the_padding():
    # 3 taps at 4 positions, pad 1: the first and last lose one tap each
    assert work.in_range_taps(4, 4, 3, 1, 1) == 10
    assert work.in_range_taps(2, 5, 3, 2, 0) == 6


def test_bound_is_the_larger_of_operations_and_bytes():
    w = work.work(config("resnet18"))
    assert w.flops_per_image == 2 * 1_660_611_328
    assert w.io_bytes_per_image == (224 * 224 * 3 + 7 * 7 * 512) * 4
    ops = 8 * w.flops_per_image / work.PEAK_FLOPS
    assert w.bound_s(8, 1) == ops
    # one image a round: the weights' bytes still lose to the operations
    assert w.bound_s(1, 1) == w.flops_per_image / work.PEAK_FLOPS
    # no operations: bytes bound it
    assert work.Work(0.0, 1.0, 0.0).bound_s(
        3, 0) == 3 / work.PEAK_HBM_BYTES_PER_S


def test_peak_is_three_tf32_passes():
    assert work.PEAK_FLOPS == 165e12

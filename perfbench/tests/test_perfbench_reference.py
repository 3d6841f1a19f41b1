"""The plain reference against the port's CPU path: small nets with pools
and residual edges that cross span cuts, and one full-width AlexNet
image."""
import pytest
import torch

from perfbench import bench, program
from perfbench.reference import cnn as reference
from perfbench.tests.conftest import TINY, config

NETS = {
    "tiny": TINY,
    # option A across a channel change and a stride, a pool with padding
    "res-down": dict(TINY, name="res-down", residual_edges=[[1, 3], [3, 5]]),
    # AlexNet's shape of stem, no residual edge
    "stem": {"name": "stem", "in_h": 35, "in_w": 35, "in_ch": 3,
             "capacity_elems": 4096,
             "layers": [["conv", 11, 4, 0, 8], ["pool", 3, 2, 0, 8],
                        ["conv", 5, 1, 2, 12], ["pool", 3, 2, 0, 12]],
             "residual_edges": []},
}


def port_outputs(cfg, params, xs):
    dep = program.deploy(cfg, torch.device("cpu"))
    return dep.run(params, xs)


@pytest.mark.parametrize("name", sorted(NETS))
def test_reference_matches_the_port_on_small_nets(name, one_thread):
    cfg = NETS[name]
    params, gen = bench.make_params(cfg, 2**31 + 7, torch.device("cpu"))
    xs = torch.randn((3, cfg["in_h"], cfg["in_w"], cfg["in_ch"]),
                     generator=gen)
    want = reference.forward(cfg, params, xs)
    got = port_outputs(cfg, params, xs)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_matches_the_port_on_a_full_width_alexnet_image(one_thread):
    cfg = config("alexnet")
    params, gen = bench.make_params(cfg, 11, torch.device("cpu"))
    xs = torch.randn((1, 227, 227, 3), generator=gen)
    want = reference.forward(cfg, params, xs)
    got = port_outputs(cfg, params, xs)
    assert tuple(got.shape) == (1, 6, 6, 256)
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap < 1e-5, gap


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12,
                      -3.0 - 2.0**-12, 0.0])
    got = reference.round_to_tf32(x)
    # 1 + 2^-11 is the halfway point: it rounds away from zero
    assert got.tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0,
                            -3.0, 0.0]


def test_the_control_differs_from_fp32():
    cfg = TINY
    params, gen = bench.make_params(cfg, 5, torch.device("cpu"))
    xs = torch.randn((2, 16, 16, 3), generator=gen)
    hi = reference.forward(cfg, params, xs)
    lo = reference.forward(cfg, params, xs, "tf32")
    assert 0 < float((hi - lo).abs().max()) < 1e-2 * float(hi.abs().max())
    with pytest.raises(ValueError):
        reference.forward(cfg, params, xs, "bf16")

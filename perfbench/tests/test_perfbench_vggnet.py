"""The ``vggnet`` configuration (VGG-19's conv body) and the two readers of
the fused span's counts per image of a round: the configuration's layers
and work, the plain reference against the port at VGG-19's full widths on
a small input, and the readers on synthetic round records."""
import types

import pytest
import torch

from perfbench import bench, program, spans, spec, work
from perfbench.reference import cnn as reference
from perfbench.tests.conftest import config

CUTS = [6, 11, 12, 13, 14, 16, 17, 18, 19]


def test_vggnet_is_configuration_e_of_the_paper():
    """16 3x3 convs in blocks of 64-64, 128-128, 256 x 4, 512 x 4 and
    512 x 4, each block ending in a 2x2 stride-2 max pool: 21 layers on a
    224 x 224 x 3 input, no shortcut, the head left out."""
    cfg = config("vggnet")
    want = []
    for n, c in [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]:
        want += [["conv", 3, 1, 1, c]] * n + [["pool", 2, 2, 0, c]]
    assert cfg["layers"] == want and len(want) == 21
    assert (cfg["in_h"], cfg["in_w"], cfg["in_ch"]) == (224, 224, 3)
    assert cfg["residual_edges"] == [] and cfg["fc_layers"] == 0
    assert cfg["published"]["fc_layers"] == 3
    assert work.out_shape(cfg) == (7, 7, 512)
    entry = {c["name"]: c for c in spec.load()["configs"]}["vggnet"]
    assert entry["reduced"] == ["fc_layers"]


def test_vggnet_work_per_image():
    cfg = config("vggnet")
    assert work.macs_per_image(cfg) == 18_834_187_008
    w = work.work(cfg)
    assert w.weight_bytes == 80_097_536
    assert w.io_bytes_per_image == (224 * 224 * 3 + 7 * 7 * 512) * 4
    # a round of 8 is bound by its operations, not its bytes
    assert w.bound_s(8, 1) == 8 * w.flops_per_image / work.PEAK_FLOPS


def test_vggnet_plans_its_stated_cuts():
    """At the configuration's capacity the port's planner cuts the ten
    spans the configuration states in ``assumed``."""
    cfg = config("vggnet")
    assert program.deploy(cfg, torch.device("cpu")).plan.boundaries == CUTS
    assert str(CUTS) in cfg["assumed"]["capacity_elems"]


def test_reference_matches_the_port_at_vggnet_widths(one_thread):
    """VGG-19 at its full widths on a 32 x 32 input, planned at 2,400,000
    elements: the same ten spans as at 224 x 224, and the port's output
    within 1e-5 of the reference's largest value."""
    cfg = dict(config("vggnet"), in_h=32, in_w=32, capacity_elems=2_400_000)
    dep = program.deploy(cfg, torch.device("cpu"))
    assert dep.plan.boundaries == CUTS
    params, gen = bench.make_params(cfg, 2**40 + 3, torch.device("cpu"))
    xs = torch.randn((1, 32, 32, 3), generator=gen)
    want = reference.forward(cfg, params, xs)
    got = dep.run(params, xs)
    assert tuple(got.shape) == (1, 1, 1, 512)
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap < 1e-5, gap


def _round(**attrs):
    return types.SimpleNamespace(name="occam.session.round", start_ns=0,
                                 end_ns=1, attrs=attrs)


@pytest.mark.parametrize("metric,attr", [
    ("weight_mb_per_image.batch", "weight_bytes"),
    ("boundary_mb_per_image.batch", "boundary_bytes")])
def test_round_count_readers(monkeypatch, metric, attr):
    """Each reader takes the mean of its attribute over the round spans
    that carry it, in MB; None where no round carries it, as with a
    program whose rounds carry no counts."""
    read = spec.reader(metric)
    other = types.SimpleNamespace(name="occam.session.submit", start_ns=0,
                                  end_ns=1, attrs={attr: 9e9})
    recs = [_round(**{attr: 3_000_000}), _round(lanes=8), other,
            _round(**{attr: 5_000_000})]
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert read(None) == pytest.approx(4.0)
    for none in ([], [_round(lanes=8), other], [_round(**{attr: None})]):
        monkeypatch.setattr(spans, "records", lambda none=none: none)
        assert read(None) is None

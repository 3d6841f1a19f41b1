"""The paper's benchmark CNNs (Table II) as NetSpecs.

Convolution + pooling layers only — the paper simulates "full network
execution except the fully-connected layers" (§IV). Layer counts follow the
paper's bookkeeping (e.g. AlexNet = 5 conv + 3 pool = 8; ResNet-N counts
convs + the stem pool).

Residual edges are identity/shortcut reads (s, t): feature map L_s is
aggregated into L_t. Downsample shortcuts use the parameter-free 'option A'
(strided subsample + channel zero-pad) in execution; the traffic model only
needs |L_s| either way.
"""
from __future__ import annotations

from repro_torch.core.graph import NetSpec, chain

C, P = "conv", "pool"


def alexnet() -> NetSpec:
    """Convnet's single-tower AlexNet ('one weird trick' channel counts —
    the paper implements Occam in Krizhevsky's Convnet; Table II shows its
    conv body fits one 3 MB partition, which holds for this variant)."""
    return chain("alexnet", [
        (C, 11, 4, 0, 64),   # 227 -> 55
        (P, 3, 2, 0, 0),     # 55 -> 27
        (C, 5, 1, 2, 192),
        (P, 3, 2, 0, 0),     # 27 -> 13
        (C, 3, 1, 1, 384),
        (C, 3, 1, 1, 256),
        (C, 3, 1, 1, 256),
        (P, 3, 2, 0, 0),     # 13 -> 6
    ], in_h=227, in_w=227, in_ch=3)


def zfnet() -> NetSpec:
    return chain("zfnet", [
        (C, 7, 2, 1, 96),    # 224 -> 110
        (P, 3, 2, 0, 0),     # 110 -> 54
        (C, 5, 2, 0, 256),   # 54 -> 25
        (P, 3, 2, 0, 0),     # 25 -> 12
        (C, 3, 1, 1, 384),
        (C, 3, 1, 1, 384),
        (C, 3, 1, 1, 256),
        (P, 3, 2, 0, 0),     # 12 -> 5
    ], in_h=224, in_w=224, in_ch=3)


def vggnet() -> NetSpec:
    """VGG-19's convolutional body (16 convs + 5 pools)."""
    spec = []
    for n_convs, ch in [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]:
        spec += [(C, 3, 1, 1, ch)] * n_convs
        spec += [(P, 2, 2, 0, 0)]
    return chain("vggnet", spec, in_h=224, in_w=224, in_ch=3)


def _resnet(name: str, blocks: list[int], bottleneck: bool) -> NetSpec:
    spec: list[tuple] = [
        (C, 7, 2, 3, 64),    # 224 -> 112
        (P, 3, 2, 1, 0),     # 112 -> 56
    ]
    edges: list[tuple[int, int]] = []
    widths = [64, 128, 256, 512]
    layer_idx = len(spec)
    for stage, n_blocks in enumerate(blocks):
        w = widths[stage]
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            start_map = layer_idx  # feature map index at block input
            if bottleneck:
                spec += [
                    (C, 1, 1, 0, w),
                    (C, 3, stride, 1, w),
                    (C, 1, 1, 0, 4 * w),
                ]
                layer_idx += 3
            else:
                spec += [
                    (C, 3, stride, 1, w),
                    (C, 3, 1, 1, w),
                ]
                layer_idx += 2
            edges.append((start_map, layer_idx))
    return chain(name, spec, in_h=224, in_w=224, in_ch=3,
                 residual_edges=edges)


def resnet18() -> NetSpec:
    return _resnet("resnet18", [2, 2, 2, 2], bottleneck=False)


def resnet34() -> NetSpec:
    return _resnet("resnet34", [3, 4, 6, 3], bottleneck=False)


def resnet50() -> NetSpec:
    return _resnet("resnet50", [3, 4, 6, 3], bottleneck=True)


def resnet101() -> NetSpec:
    return _resnet("resnet101", [3, 4, 23, 3], bottleneck=True)


def resnet152() -> NetSpec:
    return _resnet("resnet152", [3, 8, 36, 3], bottleneck=True)


PAPER_NETWORKS = {
    "alexnet": alexnet,
    "vggnet": vggnet,
    "zfnet": zfnet,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}


def get_network(name: str) -> NetSpec:
    try:
        return PAPER_NETWORKS[name]()
    except KeyError:
        raise KeyError(f"unknown network {name!r}; have {sorted(PAPER_NETWORKS)}")

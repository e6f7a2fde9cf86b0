"""Layer-wise parameter/FLOP profiles of the paper's three workloads
(ResNet50, ResNet101, VGG16), generated analytically from the architectures.

The paper's what-if simulator only needs, per layer: gradient size (bytes)
and backward-completion timing.  Sizes come from exact parameter counts
(they reproduce the paper's 97/170/527 MB model sizes); timing distributes a
measured V100 batch time across layers proportional to conv FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class LayerProfile:
    name: str
    params: int          # parameter count (fp32 gradients -> 4 bytes each)
    flops: int           # forward FLOPs per image


@dataclass(frozen=True)
class CNNProfile:
    name: str
    layers: Tuple[LayerProfile, ...]   # forward order
    t_batch_v100: float                # measured V100 batch-32 iteration (s)

    @property
    def total_params(self) -> int:
        return sum(l.params for l in self.layers)

    @property
    def total_bytes(self) -> int:
        return 4 * self.total_params

    @property
    def size_mib(self) -> float:
        return self.total_bytes / (1024.0 ** 2)


def _conv(name, cin, cout, k, hw, stride=1, bias=False) -> LayerProfile:
    out_hw = hw // stride
    params = k * k * cin * cout + (cout if bias else 0)
    flops = 2 * k * k * cin * cout * out_hw * out_hw
    return LayerProfile(name, params, flops)


def _bn(name, c) -> LayerProfile:
    return LayerProfile(name, 2 * c, 0)


def _fc(name, cin, cout) -> LayerProfile:
    return LayerProfile(name, cin * cout + cout, 2 * cin * cout)


# ---------------------------------------------------------------------------
# VGG16
# ---------------------------------------------------------------------------

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]


def vgg16() -> CNNProfile:
    layers: List[LayerProfile] = []
    cin, hw = 3, 224
    i = 0
    for v in _VGG_CFG:
        if v == "M":
            hw //= 2
            continue
        layers.append(_conv(f"conv{i}", cin, v, 3, hw, bias=True))
        cin = v
        i += 1
    layers.append(_fc("fc1", 512 * 7 * 7, 4096))   # the paper's ~400 MB layer
    layers.append(_fc("fc2", 4096, 4096))
    layers.append(_fc("fc3", 4096, 1000))
    # public V100 fp32 batch-32 training throughput ~170 img/s
    return CNNProfile("vgg16", tuple(layers), t_batch_v100=32 / 170.0)


# ---------------------------------------------------------------------------
# ResNet-50 / ResNet-101
# ---------------------------------------------------------------------------

def _bottleneck(layers, name, cin, width, hw, stride, downsample):
    cout = width * 4
    layers.append(_conv(f"{name}.conv1", cin, width, 1, hw))
    layers.append(_bn(f"{name}.bn1", width))
    layers.append(_conv(f"{name}.conv2", width, width, 3, hw, stride))
    layers.append(_bn(f"{name}.bn2", width))
    hw = hw // stride
    layers.append(_conv(f"{name}.conv3", width, cout, 1, hw))
    layers.append(_bn(f"{name}.bn3", cout))
    if downsample:
        layers.append(_conv(f"{name}.down", cin, cout, 1, hw * stride, stride))
        layers.append(_bn(f"{name}.down_bn", cout))
    return cout, hw


def _resnet(name: str, blocks: Tuple[int, ...], t_batch: float) -> CNNProfile:
    layers: List[LayerProfile] = []
    layers.append(_conv("conv1", 3, 64, 7, 224, 2))
    layers.append(_bn("bn1", 64))
    hw = 56                                   # after maxpool
    cin = 64
    for stage, n in enumerate(blocks):
        width = 64 * (2 ** stage)
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            down = b == 0
            cin, hw = _bottleneck(layers, f"s{stage}.b{b}", cin, width, hw,
                                  stride, down)
    layers.append(_fc("fc", 2048, 1000))
    return CNNProfile(name, tuple(layers), t_batch)


def resnet50() -> CNNProfile:
    # public V100 fp32 batch-32 training throughput ~345 img/s
    return _resnet("resnet50", (3, 4, 6, 3), 32 / 345.0)


def resnet101() -> CNNProfile:
    # ~205 img/s
    return _resnet("resnet101", (3, 4, 23, 3), 32 / 205.0)


PROFILES = {"vgg16": vgg16, "resnet50": resnet50, "resnet101": resnet101}


def get_profile(name: str) -> CNNProfile:
    return PROFILES[name]()

"""The paper's three workloads (ResNet-50/101, VGG-16) for image
classification, as plain functions on tensors.

Counterpart of ``repro/models/cnn.py``.  The parameter tree has the
reference's key paths and leaf shapes: conv weights are HWIO and images
NHWC, so the bucket plan of ``parallel.grad_sync`` cuts the same buckets and
the int8 codec groups the same 256 elements as JAX.  The forward permutes
at each op instead: an NHWC tensor seen as NCHW is already
``channels_last``, and HWIO seen as OIHW is ``w.permute(3, 2, 0, 1)``.

XLA's "SAME" padding puts the smaller half before when the total is odd
(a stride-2 window over an even size); ``_same_pads`` computes its rule and
an asymmetric case goes through ``F.pad`` and an unpadded op.  Batch norm
is per-batch with the biased variance and no running statistics, as in the
reference (the simulator's subject is throughput, not eval accuracy).

``cnn_api`` gives a CNN the ``cfg`` / ``init`` / ``loss_fn`` members that
``launch.train.make_train_step`` takes, so a CNN trains through that step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _device_of, dense_init

_F32 = torch.float32


def _conv_init(gen, k, cin, cout, device):
    return dense_init(gen, (k, k, cin, cout), _F32, scale=(2.0 / (k * k * cin)) ** 0.5,
                      device=device)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float) -> Tuple[torch.Tensor, int]:
    """NHWC ``x`` padded to XLA's "SAME" windows.  A symmetric pad is
    returned as a count for the op's own ``padding``; an asymmetric one is
    applied here, with ``value``."""
    (ht, hb), (wl, wr) = _same_pads(x.shape[1], k, s), _same_pads(x.shape[2], k, s)
    if ht == hb and wl == wr and ht == wl:
        return x, ht
    return F.pad(x, (0, 0, wl, wr, ht, hb), value=value), 0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """An HWIO weight seen as OIHW (a view; cuDNN lays it out for the input)."""
    return w.permute(3, 2, 0, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC ``x`` and HWIO ``w`` -> NHWC, with "SAME" or "VALID" padding."""
    pad = 0
    if padding == "SAME":
        x, pad = _pad_same(x, w.shape[0], stride, 0.0)
    elif padding != "VALID":
        raise ValueError(padding)
    return _nhwc(F.conv2d(_nchw(x), _oihw(w), stride=stride, padding=pad))


def max_pool(x: torch.Tensor, k: int, s: int, padding: str) -> torch.Tensor:
    """``reduce_window(x, -inf, max, (1, k, k, 1), (1, s, s, 1), padding)`` on NHWC."""
    pad = 0
    if padding == "SAME":
        x, pad = _pad_same(x, k, s, -math.inf)
    elif padding != "VALID":
        raise ValueError(padding)
    return _nhwc(F.max_pool2d(_nchw(x), k, s, padding=pad))


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-batch normalization of NHWC ``x`` over (N, H, W), biased variance,
    no running statistics (training mode)."""
    return _nhwc(F.batch_norm(_nchw(x), None, None, scale, bias, training=True, eps=eps))


# ---------------------------------------------------------------------------
# VGG-16
# ---------------------------------------------------------------------------

VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]


def init_vgg16(gen: Optional[torch.Generator], num_classes: int = 1000,
               width_mult: float = 1.0, device=None) -> Params:
    device = _device_of(gen, device)
    params: Params = {"convs": [], "fcs": []}
    cin = 3
    for v in VGG_CFG:
        if v == "M":
            continue
        cout = max(int(v * width_mult), 8)
        params["convs"].append({"w": _conv_init(gen, 3, cin, cout, device),
                                "b": torch.zeros(cout, device=device)})
        cin = cout
    fc_dim = max(int(4096 * width_mult), 16)
    dims = [(cin * 7 * 7, fc_dim), (fc_dim, fc_dim), (fc_dim, num_classes)]
    params["fcs"] = [{"w": dense_init(gen, d, _F32, device=device),
                      "b": torch.zeros(d[1], device=device)} for d in dims]
    return params


def vgg16_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, classes).  H = W = 224: there is
    no adaptive pool, fc1 takes the 7x7 map the canonical input lands at."""
    x = images
    i = 0
    for v in VGG_CFG:
        if v == "M":
            x = max_pool(x, 2, 2, "VALID")
            continue
        c = params["convs"][i]
        x = F.relu(conv2d(x, c["w"]) + c["b"])
        i += 1
    x = x.reshape(x.shape[0], -1)              # (h, w, c) order, as the reference
    for j, fc in enumerate(params["fcs"]):
        x = x @ fc["w"] + fc["b"]
        if j < 2:
            x = F.relu(x)
    return x


# ---------------------------------------------------------------------------
# ResNet-50 / 101
# ---------------------------------------------------------------------------

def _init_bn(c, device):
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}


def _init_bottleneck(gen, cin, width, downsample, device):
    p = {
        "conv1": _conv_init(gen, 1, cin, width, device), "bn1": _init_bn(width, device),
        "conv2": _conv_init(gen, 3, width, width, device), "bn2": _init_bn(width, device),
        "conv3": _conv_init(gen, 1, width, width * 4, device),
        "bn3": _init_bn(width * 4, device),
    }
    if downsample:
        p["down"] = _conv_init(gen, 1, cin, width * 4, device)
        p["down_bn"] = _init_bn(width * 4, device)
    return p


def init_resnet(gen: Optional[torch.Generator], blocks: Sequence[int],
                num_classes: int = 1000, width_mult: float = 1.0, device=None) -> Params:
    device = _device_of(gen, device)
    base = max(int(64 * width_mult), 8)
    params: Params = {"stem": {"w": _conv_init(gen, 7, 3, base, device),
                               "bn": _init_bn(base, device)},
                      "stages": []}
    cin = base
    for stage, n in enumerate(blocks):
        width = base * (2 ** stage)
        stage_p = []
        for b in range(n):
            stage_p.append(_init_bottleneck(gen, cin, width, b == 0, device))
            cin = width * 4
        params["stages"].append(stage_p)
    params["fc"] = {"w": dense_init(gen, (cin, num_classes), _F32, device=device),
                    "b": torch.zeros(num_classes, device=device)}
    return params


def _bottleneck_forward(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """``stride`` comes from the block's position, not from the tree."""
    h = F.relu(batch_norm(conv2d(x, p["conv1"]), p["bn1"]["scale"], p["bn1"]["bias"]))
    h = F.relu(batch_norm(conv2d(h, p["conv2"], stride=stride),
                          p["bn2"]["scale"], p["bn2"]["bias"]))
    h = batch_norm(conv2d(h, p["conv3"]), p["bn3"]["scale"], p["bn3"]["bias"])
    if "down" in p:
        x = batch_norm(conv2d(x, p["down"], stride=stride),
                       p["down_bn"]["scale"], p["down_bn"]["bias"])
    return F.relu(x + h)


def resnet_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    stem = params["stem"]
    x = F.relu(batch_norm(conv2d(images, stem["w"], stride=2),
                          stem["bn"]["scale"], stem["bn"]["bias"]))
    x = max_pool(x, 3, 2, "SAME")
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            x = _bottleneck_forward(block, x, 2 if (bi == 0 and si > 0) else 1)
    x = x.mean(dim=(1, 2))
    return x @ params["fc"]["w"] + params["fc"]["b"]


# ---------------------------------------------------------------------------
# uniform API
# ---------------------------------------------------------------------------

_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
CNN_NAMES = ("vgg16", "resnet50", "resnet101")


def get_cnn(name: str, gen: Optional[torch.Generator], num_classes: int = 1000,
            width_mult: float = 1.0, device=None) -> Tuple[Params, Callable]:
    """Returns (params, forward) for resnet50 | resnet101 | vgg16."""
    if name == "vgg16":
        return init_vgg16(gen, num_classes, width_mult, device), vgg16_forward
    if name in _BLOCKS:
        return (init_resnet(gen, _BLOCKS[name], num_classes, width_mult, device),
                resnet_forward)
    raise ValueError(name)


def cnn_loss(forward: Callable, params: Params, batch) -> torch.Tensor:
    """Mean cross-entropy; ``batch`` holds NHWC ``images`` and int ``labels``."""
    logp = F.log_softmax(forward(params, batch["images"]), dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None]).mean()


@dataclass(frozen=True)
class CNNConfig:
    """What ``make_train_step`` reads of a config, for a CNN."""
    name: str
    num_classes: int = 1000
    width_mult: float = 1.0
    use_pallas: str = "auto"     # hand-written codec kernels: auto | always | never


class CNNApi(NamedTuple):
    cfg: CNNConfig
    init: Callable               # init(generator, device=None) -> params
    loss_fn: Callable            # loss_fn(params, batch) -> (loss, {})


def cnn_api(cfg: CNNConfig) -> CNNApi:
    """A CNN in the shape of the model API that ``make_train_step`` takes."""
    _, forward = get_cnn(cfg.name, None, cfg.num_classes, cfg.width_mult, device="meta")

    def init(gen, device=None) -> Params:
        return get_cnn(cfg.name, gen, cfg.num_classes, cfg.width_mult, device)[0]

    def loss_fn(params: Params, batch) -> Tuple[torch.Tensor, Any]:
        return cnn_loss(forward, params, batch), {}

    return CNNApi(cfg, init, loss_fn)

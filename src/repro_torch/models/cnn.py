"""The paper's four CNNs as layer-wise workload tables + a trainable CIFAR CNN.

DynaComm's own experiments run VGG-19, GoogLeNet, Inception-v4 and
ResNet-152 on ILSVRC12 (224x224).  The benchmarks need their *layer-wise
heterogeneity* — per-layer parameter bytes and FLOPs — derived
analytically from the exact architectures.  Branching modules (inception
blocks, residual bottlenecks) collapse to one scheduling layer, exactly as
the paper prescribes ("parameters from different branches with the same
depth are considered as one layer"; paramless transforms fold into their
previous layer).  The tables are framework-free and copied verbatim from
the reference (``repro/models/cnn.py``), so every profile equals its
value for value.

The small CNN is a real trainable convnet (CIFAR-shaped, 32x32x3) used for
the accuracy-untouched experiment (paper Fig. 10) and as the model the
asynchronous PS trainer trains in the tests.  It keeps the reference's
parameter tree (``{"layers": [{"w", "b"} x 5]}``) and layouts — images
NHWC, convolution weights HWIO, the flatten in (H, W, C) order — so
weights carried across as numpy load unchanged.  The convolutions run in
NCHW through ``F.conv2d`` and are permuted back to NHWC before the
flatten.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.profiler import LayerProfile

_DTYPE_BYTES = 4.0  # fp32 parameters, as in the paper's MXNet setup


def _conv(name, cin, cout, k, hw, stride=1, dtype_bytes=_DTYPE_BYTES):
    """Conv layer profile at input resolution hw (output hw/stride)."""
    out_hw = hw // stride
    params = k * k * cin * cout + cout
    flops = 2.0 * k * k * cin * cout * out_hw * out_hw
    return LayerProfile(name=name, param_bytes=params * dtype_bytes,
                        flops_fwd=flops), out_hw


def _fc(name, cin, cout, dtype_bytes=_DTYPE_BYTES):
    return LayerProfile(name=name, param_bytes=(cin * cout + cout) * dtype_bytes,
                        flops_fwd=2.0 * cin * cout)


def _scale(profiles: List[LayerProfile], batch: int) -> List[LayerProfile]:
    return [LayerProfile(name=p.name, param_bytes=p.param_bytes,
                         flops_fwd=p.flops_fwd * batch) for p in profiles]


# ---------------------------------------------------------------------------
# VGG-19: 16 conv + 3 fc
# ---------------------------------------------------------------------------


def vgg19_profiles(batch: int = 32) -> List[LayerProfile]:
    cfg = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
    profs, cin, hw = [], 3, 224
    i = 0
    for cout, reps in cfg:
        for _ in range(reps):
            p, _ = _conv(f"conv{i}", cin, cout, 3, hw)
            profs.append(p)
            cin = cout
            i += 1
        hw //= 2  # maxpool folds into the previous conv (paper rule)
    profs.append(_fc("fc6", 512 * 7 * 7, 4096))
    profs.append(_fc("fc7", 4096, 4096))
    profs.append(_fc("fc8", 4096, 1000))
    return _scale(profs, batch)


# ---------------------------------------------------------------------------
# ResNet-152: conv1 + [3, 8, 36, 3] bottlenecks + fc
# ---------------------------------------------------------------------------


def _bottleneck(name, cin, mid, hw, stride):
    out_hw = hw // stride
    cout = mid * 4
    params = (1 * 1 * cin * mid) + (3 * 3 * mid * mid) + (1 * 1 * mid * cout)
    flops = 2.0 * (cin * mid * out_hw * out_hw
                   + 9 * mid * mid * out_hw * out_hw
                   + mid * cout * out_hw * out_hw)
    if stride != 1 or cin != cout:
        params += cin * cout
        flops += 2.0 * cin * cout * out_hw * out_hw
    return LayerProfile(name=name, param_bytes=params * _DTYPE_BYTES,
                        flops_fwd=flops), cout, out_hw


def resnet152_profiles(batch: int = 32) -> List[LayerProfile]:
    profs = []
    p, hw = _conv("conv1", 3, 64, 7, 224, stride=2)
    profs.append(p)
    hw //= 2  # maxpool
    cin = 64
    for stage, (mid, reps) in enumerate([(64, 3), (128, 8), (256, 36), (512, 3)]):
        for r in range(reps):
            stride = 2 if (r == 0 and stage > 0) else 1
            p, cin, hw = _bottleneck(f"s{stage}b{r}", cin, mid, hw, stride)
            profs.append(p)
    profs.append(_fc("fc", 2048, 1000))
    return _scale(profs, batch)


# ---------------------------------------------------------------------------
# GoogLeNet: stem + 9 inception modules + fc
# ---------------------------------------------------------------------------

_GOOGLE_INCEPTION = [
    # (1x1, 3x3red, 3x3, 5x5red, 5x5, poolproj, hw)
    (64, 96, 128, 16, 32, 32, 28),
    (128, 128, 192, 32, 96, 64, 28),
    (192, 96, 208, 16, 48, 64, 14),
    (160, 112, 224, 24, 64, 64, 14),
    (128, 128, 256, 24, 64, 64, 14),
    (112, 144, 288, 32, 64, 64, 14),
    (256, 160, 320, 32, 128, 128, 14),
    (256, 160, 320, 32, 128, 128, 7),
    (384, 192, 384, 48, 128, 128, 7),
]


def googlenet_profiles(batch: int = 32) -> List[LayerProfile]:
    profs = []
    p, hw = _conv("conv1", 3, 64, 7, 224, stride=2)
    profs.append(p)
    p, _ = _conv("conv2", 64, 192, 3, 56)
    profs.append(p)
    cin = 192
    for i, (c1, c3r, c3, c5r, c5, cp, hw) in enumerate(_GOOGLE_INCEPTION):
        params = (cin * c1 + cin * c3r + 9 * c3r * c3 + cin * c5r
                  + 25 * c5r * c5 + cin * cp)
        flops = 2.0 * hw * hw * (cin * c1 + cin * c3r + 9 * c3r * c3
                                 + cin * c5r + 25 * c5r * c5 + cin * cp)
        profs.append(LayerProfile(name=f"inception{i}",
                                  param_bytes=params * _DTYPE_BYTES,
                                  flops_fwd=flops))
        cin = c1 + c3 + c5 + cp
    profs.append(_fc("fc", 1024, 1000))
    return _scale(profs, batch)


# ---------------------------------------------------------------------------
# Inception-v4: stem convs + 4xA + 7xB + 3xC modules (+reductions) + fc
# ---------------------------------------------------------------------------


def _module(name, params, flops):
    return LayerProfile(name=name, param_bytes=params * _DTYPE_BYTES,
                        flops_fwd=flops)


def inceptionv4_profiles(batch: int = 32) -> List[LayerProfile]:
    profs = []
    # stem (3 convs + branch convs), folded per depth
    p, hw = _conv("stem0", 3, 32, 3, 299, stride=2)
    profs.append(p)
    p, _ = _conv("stem1", 32, 32, 3, hw)
    profs.append(p)
    p, _ = _conv("stem2", 32, 64, 3, hw)
    profs.append(p)
    profs.append(_module("stem_mix1", 64 * 96 * 9, 2.0 * 64 * 96 * 9 * 73 * 73))
    profs.append(_module("stem_mix2", 160 * 64 + 9 * 64 * 96 + 64 * 64 * 7 * 2,
                         2.0 * (160 * 64 + 9 * 64 * 96) * 71 * 71))
    # 4x Inception-A at 35x35, c=384
    for i in range(4):
        params = 384 * 96 * 2 + 384 * 64 * 2 + 9 * 64 * 96 + 9 * 96 * 96 * 2
        profs.append(_module(f"A{i}", params, 2.0 * params / _DTYPE_BYTES
                             * 0 + 2.0 * params * 35 * 35 / 4))
    profs.append(_module("redA", 9 * 384 * 384 + 384 * 192 + 9 * 192 * 224
                         + 9 * 224 * 256,
                         2.0 * (9 * 384 * 384 + 9 * 192 * 224) * 17 * 17))
    # 7x Inception-B at 17x17, c=1024
    for i in range(7):
        params = (1024 * 384 + 1024 * 192 + 1024 * 128 + 1024 * 192 * 2
                  + 7 * 192 * 224 * 2 + 7 * 224 * 256 * 2)
        profs.append(_module(f"B{i}", params, 2.0 * params * 17 * 17 / 4))
    profs.append(_module("redB", 1024 * 192 + 9 * 192 * 192 + 1024 * 256
                         + 7 * 256 * 320 + 9 * 320 * 320,
                         2.0 * (9 * 192 * 192 + 9 * 320 * 320) * 8 * 8))
    # 3x Inception-C at 8x8, c=1536
    for i in range(3):
        params = (1536 * 256 * 3 + 1536 * 384 * 2 + 3 * 384 * 256 * 4
                  + 3 * 384 * 512 + 3 * 512 * 256)
        profs.append(_module(f"C{i}", params, 2.0 * params * 8 * 8 / 4))
    profs.append(_fc("fc", 1536, 1000))
    return _scale(profs, batch)


PAPER_CNNS = {
    "vgg19": vgg19_profiles,
    "googlenet": googlenet_profiles,
    "inception-v4": inceptionv4_profiles,
    "resnet152": resnet152_profiles,
}


# ---------------------------------------------------------------------------
# the small CNN — trainable (CIFAR 32x32x3), one sched layer per conv / fc
# ---------------------------------------------------------------------------


def small_cnn_init(gen: Optional[torch.Generator] = None,
                   num_classes: int = 10) -> dict:
    """Random parameters from ``gen`` (on its device; the CPU without one):
    the reference's scales — He-normal convolutions, fc weights over 45
    and 16, zero biases — drawn by torch, so only the distribution is the
    reference's."""
    device = gen.device if gen is not None else torch.device("cpu")

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def conv_w(cin, cout, ksz=3):
        fan = ksz * ksz * cin
        return {"w": normal(ksz, ksz, cin, cout) / float(np.sqrt(fan)),
                "b": torch.zeros((cout,), device=device)}

    return {
        "layers": [
            conv_w(3, 32),
            conv_w(32, 64),
            conv_w(64, 128),
            {"w": normal(128 * 4 * 4, 256) / 45.0,
             "b": torch.zeros((256,), device=device)},
            {"w": normal(256, num_classes) / 16.0,
             "b": torch.zeros((num_classes,), device=device)},
        ]
    }


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 "SAME" convolution, stride 1: x NCHW, w HWIO."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=w.shape[0] // 2)


def small_cnn_forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 32, 32, 3) NHWC → logits (B, classes)."""
    x = images.permute(0, 3, 1, 2)
    for i in range(3):
        p = params["layers"][i]
        x = F.max_pool2d(torch.relu(_conv2d(x, p["w"], p["b"])), 2, 2)
    # the reference flattens NHWC: fc's inputs are in (H, W, C) order
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    p = params["layers"][3]
    x = torch.relu(x @ p["w"] + p["b"])
    p = params["layers"][4]
    return x @ p["w"] + p["b"]


def small_cnn_loss(params: dict, images: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(small_cnn_forward(params, images), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()

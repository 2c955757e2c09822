"""A plain ResNet-152 feature extractor (He et al., "Deep Residual
Learning for Image Recognition", arXiv:1512.03385; torchvision's v1.5
bottleneck, the stride on the 3x3 convolution), truncated after the
global average pool: 2048 features an image.

Float32 NCHW convolutions with TF32 off; inference batch norm as a scale
and a bias a channel. Input: uint8 (B, H, W, 3) RGB frames, scaled to
[0, 1] and normalized with the ImageNet mean and deviation. `fp8` runs
every convolution on float8 (e4m3) operands, each tensor scaled to the
format's largest value: the control, one step below bfloat16.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def features(P: Dict[str, torch.Tensor], blocks, frames: torch.Tensor,
             fp8: bool = False) -> torch.Tensor:
    def conv(name, x, stride=1, pad=0):
        w = P[name + ".weight"]
        if fp8:
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, stride=stride, padding=pad)

    def bn(name, x):
        return (x * P[name + ".weight"][None, :, None, None]
                + P[name + ".bias"][None, :, None, None])

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mean = torch.tensor(MEAN, device=frames.device)
        std = torch.tensor(STD, device=frames.device)
        x = ((frames.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
        x = F.relu(bn("bn1", conv("conv1", x, 2, 3)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage, n_blocks in enumerate(blocks):
            for b in range(n_blocks):
                name = "layer%d_%d" % (stage + 1, b)
                stride = 2 if (stage > 0 and b == 0) else 1
                y = F.relu(bn(name + ".bn1", conv(name + ".conv1", x)))
                y = F.relu(bn(name + ".bn2", conv(name + ".conv2", y,
                                                  stride, 1)))
                y = bn(name + ".bn3", conv(name + ".conv3", y))
                if b == 0:
                    x = bn(name + ".down_bn", conv(name + ".down_conv", x,
                                                   stride))
                x = F.relu(y + x)
        return x.mean(dim=(2, 3))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

"""ResNet-152 feature extractor (port of fancyrec_tpu/models/resnet.py).

Per-frame and per-image 2048-d features, as the reference extracts them
with torchvision's resnet152 truncated after its average pool. Inference
only: batch norm is an affine per channel (`AffineBN`, running statistics
folded into scale and bias by `params_from_torch`), computed in the
compute dtype as the JAX package computes it.

Modules are named after the JAX parameter tree (`conv1`, `bn1`,
`layer{s}_{b}.{conv1..3, bn1..3, down_conv, down_bn}`), so
`fancyrec_tpu_torch.interop` carries a JAX tree across by name. On the
card the extractor runs NHWC (`torch.channels_last`): the uint8 batch is
copied as it comes and normalized there, and its permute to NCHW is
already a channels-last view.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fancyrec_tpu_torch.device import resolve_device

RESNET152_BLOCKS = (3, 8, 36, 3)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class AffineBN(nn.Module):
    """Inference batch norm, y = x * scale + bias, in the dtype of x
    (`weight` is the JAX tree's `scale`)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        return (x * self.weight.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


class Conv(nn.Conv2d):
    """A bias-free k x k conv with symmetric padding k // 2, its weight
    cast to the dtype of the input at use (flax's `dtype=`)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride, kernel // 2, bias=False)

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: the stride sits on the 3x3 conv."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = width * 4
        self.conv1, self.bn1 = Conv(cin, width, 1), AffineBN(width)
        self.conv2, self.bn2 = Conv(width, width, 3, stride), AffineBN(width)
        self.conv3, self.bn3 = Conv(width, out, 1), AffineBN(out)
        if downsample:
            self.down_conv = Conv(cin, out, 1, stride)
            self.down_bn = AffineBN(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = (self.down_bn(self.down_conv(x))
                    if hasattr(self, "down_conv") else x)
        return F.relu(y + identity)


def _stem_s2d(x, weight):
    """The space-to-depth stem: the 7x7/2 conv as a 4x4 VALID conv over
    2x2 blocks of the input (12 channels), the kernel zero-padded to 8x8
    at the top left and folded the same way; the same output as the plain
    stem. Built on the NHWC view, so a channels-last input stays one."""
    b, _, h, w = x.shape
    o = weight.shape[0]
    # kernel (O, 3, 7, 7) -> (O, 3, 8, 8) -> (O, 12, 4, 4), channel (dy, dx, c)
    kp = F.pad(weight, (1, 0, 1, 0))
    kt = kp.reshape(o, 3, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    kt = kt.reshape(o, 12, 4, 4)
    # input: pad to coordinates -4 .. H+3, then 2x2 blocks -> 12 channels
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 4, 4, 4, 4))
    xt = xp.reshape(b, (h + 8) // 2, 2, (w + 8) // 2, 2, 3)
    xt = xt.permute(0, 1, 3, 2, 4, 5).reshape(b, (h + 8) // 2, (w + 8) // 2,
                                              12)
    y = F.conv2d(xt.permute(0, 3, 1, 2), kt)
    return y[:, :, : h // 2, : w // 2]


class ResNetFeatures(nn.Module):
    """images (B, 3, H, W) float -> (B, 2048) float32 features, taken
    after the global average pool.

    `conv1` holds the 7x7x3x64 stem kernel whichever stem consumes it;
    `stem_s2d` selects the space-to-depth stem (a TPU lane trick in the
    JAX package, kept with the same output)."""

    def __init__(self, blocks: Sequence[int] = RESNET152_BLOCKS,
                 dtype: torch.dtype = torch.bfloat16, stem_s2d: bool = False):
        super().__init__()
        self.blocks = tuple(blocks)
        self.dtype = dtype
        self.stem_s2d = stem_s2d
        self.conv1 = Conv(3, 64, 7, 2)
        self.bn1 = AffineBN(64)
        self.block_names = []
        cin, width = 64, 64
        for stage, n_blocks in enumerate(self.blocks):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = "layer%d_%d" % (stage + 1, b)
                self.add_module(name, Bottleneck(cin, width, stride,
                                                 downsample=(b == 0)))
                self.block_names.append(name)
                cin = width * 4
            width *= 2

    def forward(self, x):
        x = x.to(self.dtype)
        kernel = self.conv1.weight.to(self.dtype)
        if self.stem_s2d:
            x = _stem_s2d(x, kernel)
        else:
            x = F.conv2d(x, kernel, stride=2, padding=3)
        x = F.relu(self.bn1(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # jnp.mean of a bf16 tensor: summed in float32, rounded to bf16
        x = x.mean(dim=(2, 3), dtype=torch.float32)
        return x.to(self.dtype).float()


def blocks_of(tree: Mapping[str, Any]) -> tuple:
    """The blocks of each stage that a port state dict (`layer{s}_{b}.*`
    keys) or a JAX param tree (`layer{s}_{b}` subtrees) holds."""
    counts = [0, 0, 0, 0]
    for key in tree:
        head = key.split(".", 1)[0]
        if head.startswith("layer"):
            stage, b = head[len("layer"):].split("_")
            counts[int(stage) - 1] = max(counts[int(stage) - 1], int(b) + 1)
    return tuple(counts)


def params_from_torch(sd: Mapping[str, Any], blocks=RESNET152_BLOCKS,
                      eps: float = 1e-5) -> dict:
    """A torchvision resnet152 state dict -> the JAX package's param tree
    (numpy; batch norm folded into scale and bias), which
    `load_resnet` or `make_extractor` carry into the port."""

    def arr(k):
        v = sd[k]
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    def conv(k):
        # torch (O, I, kh, kw) -> flax (kh, kw, I, O)
        return {"kernel": np.transpose(arr(k + ".weight"), (2, 3, 1, 0))}

    def bn(k):
        gamma, beta = arr(k + ".weight"), arr(k + ".bias")
        mean, var = arr(k + ".running_mean"), arr(k + ".running_var")
        scale = gamma / np.sqrt(var + eps)
        return {"scale": scale, "bias": beta - mean * scale}

    params = {"conv1": conv("conv1"), "bn1": bn("bn1")}
    for stage, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            p = "layer%d.%d." % (stage + 1, b)
            blk = {
                "conv1": conv(p + "conv1"), "bn1": bn(p + "bn1"),
                "conv2": conv(p + "conv2"), "bn2": bn(p + "bn2"),
                "conv3": conv(p + "conv3"), "bn3": bn(p + "bn3"),
            }
            if b == 0:
                blk["down_conv"] = conv(p + "downsample.0")
                blk["down_bn"] = bn(p + "downsample.1")
            params["layer%d_%d" % (stage + 1, b)] = blk
    return params


def _imagenet_stats(device):
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


def _normalize(images_uint8, mean, std):
    return (images_uint8.to(torch.float32) / 255.0 - mean) / std


def preprocess_images(images_uint8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> float32 normalized with the ImageNet stats,
    on the tensor's device. The reference's RandomHorizontalFlip (a
    train-time augmentation it applies at extraction) is left out, as in
    the JAX package."""
    return _normalize(images_uint8, *_imagenet_stats(images_uint8.device))


def init_random_params(seed: int = 0, dtype: torch.dtype = torch.float32
                       ) -> Dict[str, torch.Tensor]:
    """A random ResNet-152 state dict from an explicit generator: conv
    kernels LeCun-normal (truncated at two standard deviations), batch
    norm scale 1 and bias 0, the JAX initializers; the same tree shapes as
    the JAX function, not the same values."""
    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        model = ResNetFeatures(RESNET152_BLOCKS)
    state = {}
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            t = torch.zeros(p.shape)
        elif p.ndim == 1:
            t = torch.ones(p.shape)
        else:
            # flax lecun_normal: variance 1 / fan_in of a truncated normal
            std = (1.0 / (p[0].numel())) ** 0.5 / .87962566103423978
            t = nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std,
                                      -2 * std, 2 * std, generator=g)
        state[name] = t.to(dtype)
    return state


def load_resnet(params_or_state: Mapping, dtype: torch.dtype = torch.float32,
                stem_s2d: bool = False) -> ResNetFeatures:
    """A port `ResNetFeatures` (on the CPU, float32 parameters) filled
    strictly from a JAX param tree (nested, flax layouts) or a port state
    dict, with the blocks the weights hold."""
    from fancyrec_tpu_torch.interop import load_jax_variables

    model = ResNetFeatures(blocks_of(params_or_state), dtype, stem_s2d)
    if isinstance(params_or_state.get("conv1"), Mapping):
        return load_jax_variables(model, params_or_state)
    model.load_state_dict({k: torch.as_tensor(v).float()
                           for k, v in params_or_state.items()})
    return model


def make_extractor(params_or_state: Mapping, batch_size: int = 128,
                   dtype: torch.dtype = torch.bfloat16, stem_s2d: bool = True,
                   device=None):
    """-> fn: uint8 images (B, 224, 224, 3), numpy or a tensor on any
    device -> (B, 2048) float32 features, a tensor on `device` (the card
    unless the caller asks for the CPU).

    The weights are cast to `dtype` once (the JAX model casts them at each
    use: the same values). On the card the model runs channels-last, and a
    first forward at `batch_size` runs here, so cuDNN's set-up is not paid
    by the first batch of a stream."""
    dev = resolve_device(device)
    model = load_resnet(params_or_state, dtype, stem_s2d)
    model = model.to(device=dev, dtype=dtype).eval().requires_grad_(False)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    # on the device once: a copy of them a call would wait for the card
    stats = _imagenet_stats(dev)

    @torch.inference_mode()
    def extract(images):
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        x = _normalize(images.to(dev, non_blocking=True), *stats)
        # NHWC-contiguous: the NCHW view is channels-last
        return model(x.permute(0, 3, 1, 2))

    if dev.type == "cuda":
        extract(torch.zeros((batch_size, 224, 224, 3), dtype=torch.uint8,
                            device=dev))
    return extract

"""ResNet-18/50 and GhostNet-style CNN classifiers: the paper's own evaluation models.

GroupNorm stands in for BatchNorm, as in the reference. The public functions
take images in the reference's NHWC layout ``[B, H, W, C]``; inside, the
images are permuted to an NCHW view, which keeps channels-last strides, and
convolution weights are stored OIHW.

Two places differ from a literal carry-over of the reference:
  * "SAME" padding of a stride-2 convolution on an even input pads (0, 1) per
    side, not (1, 1); ``conv`` computes XLA's SAME split and pads explicitly
    where it is asymmetric.
  * GroupNorm groups are ``min(8, c)`` lowered until they divide ``c``, with
    biased variance and eps 1e-5 in f32: ``F.group_norm`` with that group
    count computes the same function.
Parameter names mirror the reference's tree (``stem``, ``gn_stem.scale``,
``stages.0.0.conv1``, ``head``) so ``repro_torch.convert`` can load it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.device import resolve_device


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW convolution with XLA's "SAME" padding."""
    kh, kw = w.shape[2], w.shape[3]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def _groups(c: int) -> int:
    g = min(8, c)
    while c % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.groups = _groups(c)

    def forward(self, x):
        y = F.group_norm(x.float(), self.groups, self.scale, self.bias, eps=1e-5)
        return y.to(x.dtype)


def _conv_weight(gen, kh, kw, cin, cout) -> nn.Parameter:
    """He-normal OIHW weight, std sqrt(2 / fan_in)."""
    w = torch.randn((cout, cin, kh, kw), generator=gen) * math.sqrt(2.0 / (kh * kw * cin))
    return nn.Parameter(w)


class BasicBlock(nn.Module):
    def __init__(self, gen, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv_weight(gen, 3, 3, cin, cout)
        self.gn1 = GroupNorm(cout)
        self.conv2 = _conv_weight(gen, 3, 3, cout, cout)
        self.gn2 = GroupNorm(cout)
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.proj = _conv_weight(gen, 1, 1, cin, cout)
            self.gnp = GroupNorm(cout)

    def forward(self, x):
        h = F.relu(self.gn1(conv(x, self.conv1, self.stride)))
        h = self.gn2(conv(h, self.conv2))
        sc = self.gnp(conv(x, self.proj, self.stride)) if self.has_proj else x
        return F.relu(h + sc)


class Bottleneck(nn.Module):
    def __init__(self, gen, cin: int, cout: int, stride: int):
        super().__init__()
        mid = cout // 4
        self.stride = stride
        self.conv1 = _conv_weight(gen, 1, 1, cin, mid)
        self.gn1 = GroupNorm(mid)
        self.conv2 = _conv_weight(gen, 3, 3, mid, mid)
        self.gn2 = GroupNorm(mid)
        self.conv3 = _conv_weight(gen, 1, 1, mid, cout)
        self.gn3 = GroupNorm(cout)
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.proj = _conv_weight(gen, 1, 1, cin, cout)
            self.gnp = GroupNorm(cout)

    def forward(self, x):
        h = F.relu(self.gn1(conv(x, self.conv1)))
        h = F.relu(self.gn2(conv(h, self.conv2, self.stride)))
        h = self.gn3(conv(h, self.conv3))
        sc = self.gnp(conv(x, self.proj, self.stride)) if self.has_proj else x
        return F.relu(h + sc)


class GhostBlock(nn.Module):
    """Ghost module: half the features from a dense 3x3 conv (``primary``),
    half from a cheap depthwise 3x3 conv on those (``cheap``, ``[half, 1, 3,
    3]``, cast to the activation dtype as in the reference)."""

    def __init__(self, gen, cin: int, cout: int, stride: int):
        super().__init__()
        half = cout // 2
        self.stride = stride
        self.primary = _conv_weight(gen, 3, 3, cin, half)
        self.gn1 = GroupNorm(half)
        self.cheap = nn.Parameter(torch.randn((half, 1, 3, 3), generator=gen) * 0.2)
        self.gn2 = GroupNorm(half)
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.proj = _conv_weight(gen, 1, 1, cin, cout)
            self.gnp = GroupNorm(cout)

    def forward(self, x):
        prim = F.relu(self.gn1(conv(x, self.primary, self.stride)))
        # torch's multi-threaded CPU backward of a depthwise conv on a
        # channels-last input corrupts the heap (seen with torch 2.13+cpu);
        # the CPU takes it on a contiguous copy
        src = prim.contiguous() if prim.device.type == "cpu" else prim
        cheap = F.conv2d(src, self.cheap.to(prim.dtype), padding=1, groups=prim.shape[1])
        cheap = F.relu(self.gn2(cheap))
        h = torch.cat([prim, cheap], dim=1)
        sc = self.gnp(conv(x, self.proj, self.stride)) if self.has_proj else x
        return F.relu(h + sc)


_BLOCKS = {"resnet18": (BasicBlock, 1), "resnet50": (Bottleneck, 4),
           "ghostnet": (GhostBlock, 1)}


class CNN(nn.Module):
    """3x3 stride-1 stem (no max-pool), stages of blocks, mean pool, linear
    head kept as a ``[D, classes]`` matrix as in the reference."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        block, expand = _BLOCKS[cfg.variant]
        self.stem = _conv_weight(gen, 3, 3, cfg.channels, cfg.width)
        self.gn_stem = GroupNorm(cfg.width)
        cin = cfg.width
        stages = []
        for s, nblocks in enumerate(cfg.stage_blocks):
            cout = cfg.width * (2 ** s) * expand
            blocks = []
            for b in range(nblocks):
                blocks.append(block(gen, cin, cout, 2 if (b == 0 and s > 0) else 1))
                cin = cout
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.head = nn.Parameter(
            torch.randn((cin, cfg.num_classes), generator=gen) / math.sqrt(cin))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels-last strides
        x = F.relu(self.gn_stem(conv(x, self.stem)))
        for blocks in self.stages:
            for blk in blocks:
                x = blk(x)
        x = x.mean(dim=(2, 3))
        return {"logits": x @ self.head.to(x.dtype), "embed": x}


def init_cnn(gen: torch.Generator, cfg, device=None) -> CNN:
    """Random weights drawn from ``gen`` (a CPU generator, so the same seed
    gives the same model on every device), moved to ``device`` (``None``:
    the card)."""
    return CNN(cfg, gen).to(resolve_device(device))


def cnn_outputs(model: CNN, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """images [B,H,W,C] -> {"logits": [B, classes], "embed": [B, D]}."""
    return model(images)


def apply_cnn(model: CNN, images: torch.Tensor) -> torch.Tensor:
    """images [B,H,W,C] -> logits [B, classes]."""
    return model(images)["logits"]

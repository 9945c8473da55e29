"""U-Net encoder/decoder for semantic segmentation — the port of
``tensorflowonspark_tpu/models/unet.py``.

NHWC images in, per-pixel float32 logits ``[N, H, W, num_classes]``
out; NCHW (``channels_last`` in memory) inside. bfloat16 convolutions
with float32 parameters and flax-convention BatchNorm (momentum 0.9,
epsilon 1e-5). Two layers differ from torch's defaults: the strided
``SAME`` down convolution pads asymmetrically
(``_layers.conv2d_same``), and the up convolution is flax's
``ConvTranspose``, whose kernel is not flipped (``_layers.ConvTranspose``
holds it flipped for ``conv_transpose2d``). ``in_channels`` is the
port's (torch needs it at construction; flax infers it).

Nothing of the reference is left out.
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import _layers


class ConvBlock(nn.Module):
    """Two 3x3 conv+BN+relu — the per-resolution workhorse."""

    def __init__(self, in_features, filters, dtype=torch.bfloat16,
                 bn_dtype=torch.float32, device=None):
        super(ConvBlock, self).__init__()
        conv = functools.partial(_layers.Conv, use_bias=False, dtype=dtype,
                                 device=device)
        norm = functools.partial(_layers.BatchNorm, momentum=0.9,
                                 epsilon=1e-5, dtype=bn_dtype, device=device)
        self.Conv_0 = conv(in_features, filters, 3)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3)
        self.BatchNorm_1 = norm(filters)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return F.relu(self.BatchNorm_1(self.Conv_1(x)))


class UNet(nn.Module):
    """U-Net: encoder pyramid, bottleneck, decoder with skip concats.
    Inputs must be divisible by ``2 ** len(features)``."""

    def __init__(self, num_classes, features=(32, 64, 128),
                 dtype=torch.bfloat16, bn_dtype=torch.float32,
                 in_channels=3, device=None):
        super(UNet, self).__init__()
        self.num_classes = num_classes
        self.features = tuple(features)
        self.dtype = dtype
        block = functools.partial(ConvBlock, dtype=dtype, bn_dtype=bn_dtype,
                                  device=device)
        n_blocks = n_convs = 0
        self.down = []
        c = in_channels
        for f in self.features:
            names = ("ConvBlock_%d" % n_blocks, "Conv_%d" % n_convs)
            self.add_module(names[0], block(c, f))
            # strided conv downsample (SAME at stride 2: asymmetric pad)
            self.add_module(names[1], _layers.Conv(
                f, f, 3, strides=2, use_bias=False, dtype=dtype,
                device=device))
            self.down.append(names)
            n_blocks += 1
            n_convs += 1
            c = f
        self.bottleneck = "ConvBlock_%d" % n_blocks
        self.add_module(self.bottleneck, block(c, self.features[-1] * 2))
        n_blocks += 1
        c = self.features[-1] * 2
        self.up = []
        for i, f in enumerate(reversed(self.features)):
            names = ("ConvTranspose_%d" % i, "ConvBlock_%d" % n_blocks)
            self.add_module(names[0], _layers.ConvTranspose(
                c, f, 2, 2, dtype=dtype, device=device))
            self.add_module(names[1], block(2 * f, f))
            self.up.append(names)
            n_blocks += 1
            c = f
        # float32 logits: the loss/softmax is the sensitive op
        self.head = "Conv_%d" % n_convs
        self.add_module(self.head, _layers.Conv(
            c, num_classes, 1, dtype=torch.float32, device=device))

    def init_weights(self, generator):
        return _layers.init_weights(self, generator)

    def forward(self, x):
        x = _layers.nhwc_to_nchw(x.to(self.dtype))
        skips = []
        for blk, down in self.down:
            x = getattr(self, blk)(x)
            skips.append(x)
            x = getattr(self, down)(x)
        x = getattr(self, self.bottleneck)(x)
        for (up, blk), skip in zip(self.up, reversed(skips)):
            x = getattr(self, up)(x)
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
            x = getattr(self, blk)(x)
        x = getattr(self, self.head)(x.float())
        return _layers.nchw_to_nhwc(x)


def segmentation_loss(logits, batch):
    """Mean per-pixel softmax cross-entropy; ``batch['y']`` is
    ``[N, H, W]`` int."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           batch["y"].reshape(-1).long())


def mean_iou(logits, labels, num_classes):
    """Mean intersection-over-union across classes (a class absent from
    both prediction and labels counts 1)."""
    preds = logits.argmax(dim=-1)
    labels = torch.as_tensor(labels, device=preds.device)
    ious = []
    for c in range(num_classes):
        p = preds == c
        t = labels == c
        inter = (p & t).sum()
        union = (p | t).sum()
        ious.append(torch.where(union > 0,
                                inter / torch.clamp(union, min=1),
                                torch.ones((), device=preds.device)))
    return torch.stack(ious).mean()

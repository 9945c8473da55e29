"""ResNet v1.5 family — the port of
``tensorflowonspark_tpu/models/resnet.py`` (ResNet-50 is the flagship
benchmark model).

Images come in as NHWC ``[B, H, W, 3]`` and go to NCHW
(``channels_last`` in memory) inside. bfloat16 convolutions with
float32 parameters, float32 BatchNorm (flax convention, see
``_layers.BatchNorm``: momentum 0.9 is the old statistic's weight,
epsilon 1e-5) and a float32 head. v1.5: the stride sits on the
bottleneck's 3x3, whose ``SAME`` padding at stride 2 is asymmetric
(``_layers.conv2d_same``); the stem's explicit 3-pixel pad and its max
pool's 1-pixel pad are symmetric. The last BatchNorm of each block
starts with a zero scale. Module names are flax's, so ``convert.py``
maps the trees by name.

The mode is the module's ``training`` flag (the reference's ``train=``).
Nothing of the reference is left out.
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import _layers


class BottleneckBlock(nn.Module):
    def __init__(self, in_features, filters, strides=1,
                 dtype=torch.bfloat16, bn_dtype=torch.float32, device=None):
        super(BottleneckBlock, self).__init__()
        conv = functools.partial(_layers.Conv, use_bias=False, dtype=dtype,
                                 device=device)
        norm = functools.partial(_layers.BatchNorm, momentum=0.9,
                                 epsilon=1e-5, dtype=bn_dtype, device=device)
        self.Conv_0 = conv(in_features, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, strides=strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)
        # zero-init the last BN scale: identity-ish residual at init
        self.BatchNorm_2 = norm(filters * 4, scale_init=0.0)
        self.project = in_features != filters * 4 or strides != 1
        if self.project:
            self.Conv_3 = conv(in_features, filters * 4, 1, strides=strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.project:
            residual = self.norm_proj(self.Conv_3(residual))
        return F.relu(residual + y.to(residual.dtype))


class ResNet(nn.Module):
    """ResNet v1.5. ``stage_sizes=[3, 4, 6, 3]`` is ResNet-50."""

    def __init__(self, stage_sizes, num_classes=1000, width=64,
                 dtype=torch.bfloat16, bn_dtype=torch.float32,
                 cifar_stem=False, device=None):
        super(ResNet, self).__init__()
        self.stage_sizes = list(stage_sizes)
        self.num_classes = num_classes
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.conv_init = _layers.Conv(3, width, 3,
                                          use_bias=False, dtype=dtype,
                                          device=device)
        else:
            self.conv_init = _layers.Conv(3, width, 7, strides=2,
                                          padding=[(3, 3), (3, 3)],
                                          use_bias=False, dtype=dtype,
                                          device=device)
        self.bn_init = _layers.BatchNorm(width, momentum=0.9, epsilon=1e-5,
                                         dtype=bn_dtype, device=device)
        self.blocks = []
        features = width
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                name = "BottleneckBlock_%d" % len(self.blocks)
                self.add_module(name, BottleneckBlock(
                    features, width * 2 ** i, strides, dtype=dtype,
                    bn_dtype=bn_dtype, device=device))
                self.blocks.append(name)
                features = width * 2 ** i * 4
        self.Dense_0 = _layers.Dense(features, num_classes,
                                     dtype=torch.float32, device=device)

    def init_weights(self, generator):
        return _layers.init_weights(self, generator)

    def forward(self, x):
        # x: [B, H, W, 3] float32
        x = _layers.nhwc_to_nchw(x.to(self.dtype))
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3])
#: CIFAR-sized variant used by examples/resnet
ResNet50Cifar = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                                  num_classes=10)

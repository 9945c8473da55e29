"""Inception-v3 — the port of ``tensorflowonspark_tpu/models/inception.py``
(batch inference at 299x299 is the configuration it serves).

Stem, 3x block A, grid reduction A, 4x block B, grid reduction B, 2x
block C, mean pool, dropout and a float32 head. NHWC ``[B, 299, 299,
3]`` in, NCHW (``channels_last`` in memory) inside; bfloat16
convolutions with float32 parameters, and ``ConvBN``'s flax-convention
BatchNorm with momentum 0.9997 (torch's 0.0003) and epsilon 1e-3.
``_avg_pool_same`` is a 3x3 stride-1 pool with symmetric 1-pixel
padding that counts the padded zeros, as flax's ``avg_pool`` does.
Module names are flax's (``ConvBN_i`` numbered per block in call
order), so ``convert.py`` maps the trees by name.

Nothing of the reference is left out.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import _layers


class ConvBN(nn.Module):
    def __init__(self, in_features, features, kernel, strides=1,
                 padding="SAME", dtype=torch.bfloat16, device=None):
        super(ConvBN, self).__init__()
        self.Conv_0 = _layers.Conv(in_features, features, kernel,
                                   strides=strides, padding=padding,
                                   use_bias=False, dtype=dtype,
                                   device=device)
        self.BatchNorm_0 = _layers.BatchNorm(features, momentum=0.9997,
                                             epsilon=1e-3,
                                             dtype=torch.float32,
                                             device=device)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max_pool_valid(x):
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """A block whose ``ConvBN``s are named ``ConvBN_0..`` in the order
    they are added; the branches hold them in plain lists, so each is
    registered once, under its flax name."""

    def __init__(self, dtype, device):
        super(_Block, self).__init__()
        self._dtype = dtype
        self._device = device
        self._n = 0

    def conv(self, in_features, features, kernel, strides=1,
             padding="SAME"):
        name = "ConvBN_%d" % self._n
        self._n += 1
        self.add_module(name, ConvBN(in_features, features, kernel, strides,
                                     padding, self._dtype, self._device))
        return getattr(self, name)


class InceptionA(_Block):
    def __init__(self, in_features, pool_features, dtype=torch.bfloat16,
                 device=None):
        super(InceptionA, self).__init__(dtype, device)
        c = in_features
        self.b1 = [self.conv(c, 64, (1, 1))]
        self.b2 = [self.conv(c, 48, (1, 1)), self.conv(48, 64, (5, 5))]
        self.b3 = [self.conv(c, 64, (1, 1)), self.conv(64, 96, (3, 3)),
                   self.conv(96, 96, (3, 3))]
        self.b4 = [self.conv(c, pool_features, (1, 1))]
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        outs = []
        for branch in (self.b1, self.b2, self.b3):
            y = x
            for layer in branch:
                y = layer(y)
            outs.append(y)
        outs.append(self.b4[0](_avg_pool_same(x)))
        return torch.cat(outs, dim=1)


class ReductionA(_Block):
    def __init__(self, in_features, dtype=torch.bfloat16, device=None):
        super(ReductionA, self).__init__(dtype, device)
        c = in_features
        self.b1 = [self.conv(c, 384, (3, 3), strides=2, padding="VALID")]
        self.b2 = [self.conv(c, 64, (1, 1)), self.conv(64, 96, (3, 3)),
                   self.conv(96, 96, (3, 3), strides=2, padding="VALID")]
        self.out_features = 384 + 96 + c

    def forward(self, x):
        y = x
        for layer in self.b2:
            y = layer(y)
        return torch.cat([self.b1[0](x), y, _max_pool_valid(x)], dim=1)


class InceptionB(_Block):
    def __init__(self, in_features, channels_7x7, dtype=torch.bfloat16,
                 device=None):
        super(InceptionB, self).__init__(dtype, device)
        c, m = in_features, channels_7x7
        self.b1 = [self.conv(c, 192, (1, 1))]
        self.b2 = [self.conv(c, m, (1, 1)), self.conv(m, m, (1, 7)),
                   self.conv(m, 192, (7, 1))]
        self.b3 = [self.conv(c, m, (1, 1)), self.conv(m, m, (7, 1)),
                   self.conv(m, m, (1, 7)), self.conv(m, m, (7, 1)),
                   self.conv(m, 192, (1, 7))]
        self.b4 = [self.conv(c, 192, (1, 1))]
        self.out_features = 4 * 192

    def forward(self, x):
        outs = []
        for branch in (self.b1, self.b2, self.b3):
            y = x
            for layer in branch:
                y = layer(y)
            outs.append(y)
        outs.append(self.b4[0](_avg_pool_same(x)))
        return torch.cat(outs, dim=1)


class ReductionB(_Block):
    def __init__(self, in_features, dtype=torch.bfloat16, device=None):
        super(ReductionB, self).__init__(dtype, device)
        c = in_features
        self.b1 = [self.conv(c, 192, (1, 1)),
                   self.conv(192, 320, (3, 3), strides=2, padding="VALID")]
        self.b2 = [self.conv(c, 192, (1, 1)), self.conv(192, 192, (1, 7)),
                   self.conv(192, 192, (7, 1)),
                   self.conv(192, 192, (3, 3), strides=2, padding="VALID")]
        self.out_features = 320 + 192 + c

    def forward(self, x):
        outs = []
        for branch in (self.b1, self.b2):
            y = x
            for layer in branch:
                y = layer(y)
            outs.append(y)
        outs.append(_max_pool_valid(x))
        return torch.cat(outs, dim=1)


class InceptionC(_Block):
    def __init__(self, in_features, dtype=torch.bfloat16, device=None):
        super(InceptionC, self).__init__(dtype, device)
        c = in_features
        self.b1 = [self.conv(c, 320, (1, 1))]
        self.b2 = [self.conv(c, 384, (1, 1))]
        self.b2_split = [self.conv(384, 384, (1, 3)),
                         self.conv(384, 384, (3, 1))]
        self.b3 = [self.conv(c, 448, (1, 1)), self.conv(448, 384, (3, 3))]
        self.b3_split = [self.conv(384, 384, (1, 3)),
                         self.conv(384, 384, (3, 1))]
        self.b4 = [self.conv(c, 192, (1, 1))]
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x):
        b2 = self.b2[0](x)
        b3 = x
        for layer in self.b3:
            b3 = layer(b3)
        return torch.cat(
            [self.b1[0](x)]
            + [layer(b2) for layer in self.b2_split]
            + [layer(b3) for layer in self.b3_split]
            + [self.b4[0](_avg_pool_same(x))], dim=1)


class InceptionV3(_Block):
    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 dropout_rate=0.2, device=None):
        super(InceptionV3, self).__init__(dtype, device)
        self.num_classes = num_classes
        self.dtype = dtype
        # stem: 299x299x3 -> 35x35x192
        self.stem = [self.conv(3, 32, (3, 3), strides=2,
                               padding="VALID"),
                     self.conv(32, 32, (3, 3), padding="VALID"),
                     self.conv(32, 64, (3, 3))]
        self.stem2 = [self.conv(64, 80, (1, 1), padding="VALID"),
                      self.conv(80, 192, (3, 3), padding="VALID")]
        self.blocks = []
        c = 192
        plan = [(InceptionA, (32,)), (InceptionA, (64,)),
                (InceptionA, (64,)), (ReductionA, ()),
                (InceptionB, (128,)), (InceptionB, (160,)),
                (InceptionB, (160,)), (InceptionB, (192,)),
                (ReductionB, ()), (InceptionC, ()), (InceptionC, ())]
        counts = {}
        for cls, args in plan:
            name = "%s_%d" % (cls.__name__, counts.get(cls, 0))
            counts[cls] = counts.get(cls, 0) + 1
            block = cls(c, *args, dtype=dtype, device=device)
            self.add_module(name, block)
            self.blocks.append(name)
            c = block.out_features
        self.dropout = nn.Dropout(dropout_rate)
        self.logits = _layers.Dense(c, num_classes, dtype=torch.float32,
                                    device=device)

    def init_weights(self, generator):
        return _layers.init_weights(self, generator)

    def forward(self, x):
        x = _layers.nhwc_to_nchw(x.to(self.dtype))
        for layer in self.stem:
            x = layer(x)
        x = _max_pool_valid(x)
        for layer in self.stem2:
            x = layer(x)
        x = _max_pool_valid(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = self.dropout(x.mean(dim=(2, 3)))
        return self.logits(x)

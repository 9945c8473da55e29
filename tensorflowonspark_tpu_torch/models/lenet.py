"""LeNet-style MNIST CNN — the port of
``tensorflowonspark_tpu/models/lenet.py``.

Conv(32)-Conv(64)-Dense(256)-Dense(10) on ``[B, 28, 28, 1]`` images
(NHWC, as the reference takes them), bfloat16 products with float32
parameters and float32 logits. The flatten before ``Dense_0`` is in the
reference's H, W, C order, so a converted flax kernel lines up.

Nothing of the reference is left out.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import _layers


class LeNet(nn.Module):
    """Conv(32)-Conv(64)-Dense(256)-Dense(10), bfloat16 compute."""

    def __init__(self, num_classes=10, dtype=torch.bfloat16, device=None):
        super(LeNet, self).__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.Conv_0 = _layers.Conv(1, 32, 3, dtype=dtype, device=device)
        self.Conv_1 = _layers.Conv(32, 64, 3, dtype=dtype, device=device)
        # 28x28 after two 2x2 pools: 7x7x64
        self.Dense_0 = _layers.Dense(7 * 7 * 64, 256, dtype=dtype,
                                     device=device)
        self.Dense_1 = _layers.Dense(256, num_classes, dtype=torch.float32,
                                     device=device)

    def init_weights(self, generator):
        return _layers.init_weights(self, generator)

    def forward(self, x):
        # x: [B, 28, 28, 1] float32 in [0, 1]
        x = _layers.nhwc_to_nchw(x.to(self.dtype))
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = _layers.nchw_to_nhwc(x).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)

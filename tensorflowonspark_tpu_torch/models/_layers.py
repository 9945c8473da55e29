"""flax-convention layers for the model zoo (the port's own; the JAX
package has no counterpart, flax supplies these there).

Each layer computes what the flax layer of the same name computes, on
NCHW tensors (the models take NHWC at their boundary, as the reference
does, and permute once: the permuted tensor is ``channels_last`` in
memory). Four flax conventions differ from torch's defaults, and each
gives wrong numbers silently if the torch layer is used as it is:

- **TF ``SAME`` padding** (:func:`same_pads`, :func:`conv2d_same`): the
  padding comes from the input size, ``pad_total = max((ceil(in/s) - 1)
  s + k - in, 0)``, with the smaller half first. At stride 2 it is
  asymmetric, where torch's ``padding=k//2`` is symmetric and shifts the
  whole output by a pixel.
- **``ConvTranspose`` does not flip its kernel** (flax's
  ``transpose_kernel=False``): :class:`ConvTranspose` stores the torch
  ``[in, out, kh, kw]`` weight, which is the flax kernel flipped in space
  (``convert.py`` flips it).
- **``BatchNorm``** (:class:`BatchNorm`): the running variance is updated
  with the BIASED batch variance, ``momentum`` is the weight of the OLD
  statistic (flax 0.9 is torch 0.1), and statistics are float32.
- **compute dtype** (``dtype=``): parameters stay float32; a layer
  casts its input and its weights to ``dtype`` for its product, as
  flax's ``promote_dtype`` does. The port uses explicit casts, not
  ``torch.autocast``, whose op lists are not flax's rule.

:func:`init_weights` draws flax's default initialisers (lecun-normal
kernels, zero biases, unit norm scales, embeddings of variance
``1/features``) from a ``torch.Generator``; it draws a plain normal of
lecun's variance where flax truncates it at two deviations.

Nothing of the reference is left out: it has no such module.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

#: flax ``nn.LayerNorm``'s default epsilon
LN_EPS = 1e-6


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def same_pads(size, kernel, stride):
    """TF/flax ``SAME`` padding of one spatial dim: ``(lo, hi)`` with the
    smaller half first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x, kernel, stride, padding):
    """``((h_lo, h_hi), (w_lo, w_hi))`` for ``padding`` "SAME", "VALID"
    or explicit ``[(lo, hi), (lo, hi)]`` on NCHW ``x``."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError("padding must be 'SAME', 'VALID' or explicit "
                             "pairs, got {!r}".format(padding))
        return (same_pads(x.shape[2], kernel[0], stride[0]),
                same_pads(x.shape[3], kernel[1], stride[1]))
    (a, b), (c, d) = padding
    return (int(a), int(b)), (int(c), int(d))


def conv2d_same(x, weight, bias=None, stride=1, padding="SAME"):
    """flax ``nn.Conv``'s convolution on NCHW ``x`` with an OIHW
    ``weight``: symmetric padding goes to ``conv2d`` itself, asymmetric
    padding (``SAME`` at stride 2) is applied first with ``F.pad``."""
    stride = _pair(stride)
    (hl, hh), (wl, wh) = _pads(x, weight.shape[2:], stride, padding)
    if hl == hh and wl == wh:
        return F.conv2d(x, weight, bias, stride, padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), weight, bias, stride)


def conv_transpose(x, weight, stride):
    """flax ``nn.ConvTranspose(padding="SAME")`` on NCHW ``x``, with
    ``weight`` in torch's ``[in, out, kh, kw]`` layout (the flax kernel
    flipped in space). flax pads the dilated input by ``(a, b)`` per dim
    (``lax.conv_transpose``'s SAME rule); ``conv_transpose2d`` pads it
    by ``k - 1 - padding`` before and ``output_padding`` more after."""
    stride = _pair(stride)
    pad, extra = [], []
    for k, s in zip(weight.shape[2:], stride):
        total = k + s - 2
        a = k - 1 if s > k - 1 else int(math.ceil(total / 2.0))
        b = total - a
        if a > k - 1 or b - a < 0 or b - a >= s:
            raise ValueError("no conv_transpose2d padding for kernel {} "
                             "stride {}".format(k, s))
        pad.append(k - 1 - a)
        extra.append(b - a)
    return F.conv_transpose2d(x, weight, None, stride, padding=tuple(pad),
                              output_padding=tuple(extra))


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` (NCHW in and out, OIHW weight): ``padding`` is
    "SAME" (the default), "VALID" or ``[(lo, hi), (lo, hi)]``; input and
    weights are cast to ``dtype`` for the product."""

    def __init__(self, in_features, features, kernel, strides=1,
                 padding="SAME", use_bias=True, dtype=torch.bfloat16,
                 device=None):
        super(Conv, self).__init__(in_features, features, _pair(kernel),
                                   stride=_pair(strides), padding=0,
                                   bias=use_bias, device=device)
        self.flax_padding = padding
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return conv2d_same(x.to(self.dtype), self.weight.to(self.dtype),
                           bias, self.stride, self.flax_padding)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(padding="SAME", use_bias=False)``: torch
    weight ``[in, out, kh, kw]`` = the flax kernel flipped in space."""

    def __init__(self, in_features, features, kernel, strides,
                 dtype=torch.bfloat16, device=None):
        super(ConvTranspose, self).__init__(
            in_features, features, _pair(kernel), stride=_pair(strides),
            bias=False, device=device)
        self.dtype = dtype

    def forward(self, x):
        return conv_transpose(x.to(self.dtype), self.weight.to(self.dtype),
                              self.stride)


class Dense(nn.Linear):
    """flax ``nn.Dense``: input, weight and bias cast to ``dtype``."""

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.bfloat16, device=None):
        super(Dense, self).__init__(in_features, features, bias=use_bias,
                                    device=device)
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Embed(nn.Embedding):
    """flax ``nn.Embed``: the gathered rows in ``dtype`` (a gather is
    exact, so casting after it equals flax's cast of the table)."""

    def __init__(self, num_embeddings, features, dtype=torch.bfloat16,
                 device=None):
        super(Embed, self).__init__(num_embeddings, features, device=device)
        self.dtype = dtype

    def forward(self, ids):
        return F.embedding(ids.long(), self.weight).to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis (dim 1).

    Training: normalise with the batch's mean and biased variance
    (float32) and update ``running = momentum * running + (1 - momentum)
    * batch``, the variance biased too. Eval: normalise with the running
    statistics. The output is in ``dtype`` (flax ``BatchNorm(dtype=)``).
    ``scale_init`` 0 is flax's ``scale_init=zeros``."""

    def __init__(self, num_features, momentum=0.99, epsilon=1e-5,
                 dtype=torch.float32, scale_init=1.0, device=None):
        super(BatchNorm, self).__init__()
        self.num_features = num_features
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.dtype = dtype
        self.scale_init = float(scale_init)
        self.weight = nn.Parameter(torch.full((num_features,), scale_init,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x):
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.epsilon).to(self.dtype)
        # the fused batch_norm normalises with the batch's biased
        # variance and, at momentum 1, hands back the batch's mean and
        # UNBIASED variance as its "running" statistics; the flax update
        # takes the biased one, n/(n-1) smaller
        c = self.num_features
        mean = torch.zeros(c, dtype=torch.float32, device=xf.device)
        var = torch.zeros(c, dtype=torch.float32, device=xf.device)
        y = F.batch_norm(xf, mean, var, self.weight, self.bias,
                         training=True, momentum=1.0, eps=self.epsilon)
        n = xf.numel() // c
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=(1.0 - m) * (n - 1) / n)
        return y.to(self.dtype)

    def extra_repr(self):
        return "{}, momentum={}, epsilon={}, dtype={}".format(
            self.num_features, self.momentum, self.epsilon, self.dtype)


def nhwc_to_nchw(x):
    """``[B, H, W, C]`` -> ``[B, C, H, W]`` (a view, ``channels_last``
    in memory)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def init_weights(module, generator):
    """flax's default initialisers, drawn from ``generator`` (which must
    live on the parameters' device): conv and dense weights normal with
    variance ``1/fan_in``, biases 0, norm scales 1 (a :class:`BatchNorm`'s
    ``scale_init``), embeddings normal with variance ``1/features``,
    running statistics 0 and 1. Buffers of quantized tables are left."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(m.scale_init)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                 generator=generator)
            elif isinstance(m, nn.ConvTranspose2d):
                w = m.weight                       # [in, out, kh, kw]
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight                       # [out, in, ...]
                fan_in = w[0].numel()
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module

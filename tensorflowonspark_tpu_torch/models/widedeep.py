"""Wide & Deep recommender (Criteo-shaped) — the port of
``tensorflowonspark_tpu/models/widedeep.py``.

Inputs: ``dense [B, 13]`` float features and ``cat [B, 26]`` integer ids
already hashed into ``hash_buckets`` (:func:`hash_categorical`, the ETL
step). One fused embedding table of ``hash_buckets * num_cat`` rows
serves every slot, each slot offset into its own region; the deep MLP
runs in bfloat16 with a float32 head, and the wide part is a float32
1-wide embedding on the same ids plus a float32 dense layer.

``quantized=True`` swaps the deep table for :class:`QuantizedEmbed`:
int8 rows and a float32 per-row scale held as BUFFERS (the reference's
``quant`` collection, outside ``params``), so no optimizer sees them.
:func:`quantize_embeddings` makes them from a trained model's
``state_dict``. :func:`hash_categorical` is the reference's, copied (the
port imports nothing of the JAX package).

Nothing of the reference is left out.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import _layers


class WideDeep(nn.Module):
    def __init__(self, num_dense=13, num_cat=26, hash_buckets=100_000,
                 embed_dim=32, mlp_sizes=(256, 128, 64),
                 dtype=torch.bfloat16, quantized=False, device=None):
        super(WideDeep, self).__init__()
        self.num_dense = num_dense
        self.num_cat = num_cat
        self.hash_buckets = hash_buckets
        self.embed_dim = embed_dim
        self.mlp_sizes = tuple(mlp_sizes)
        self.dtype = dtype
        self.quantized = quantized
        table_size = hash_buckets * num_cat
        # only the DEEP table quantizes: the wide table's rows are 1
        # element, where a per-row scale would make int8 larger than f32
        deep_cls = QuantizedEmbed if quantized else _layers.Embed
        self.deep_embeddings = deep_cls(table_size, embed_dim, dtype=dtype,
                                        device=device)
        widths = [num_cat * embed_dim + num_dense] + list(self.mlp_sizes)
        self.mlp = ["mlp_%d" % i for i in range(len(self.mlp_sizes))]
        for i, name in enumerate(self.mlp):
            self.add_module(name, _layers.Dense(widths[i], widths[i + 1],
                                                dtype=dtype, device=device))
        self.deep_head = _layers.Dense(widths[-1], 1, dtype=torch.float32,
                                       device=device)
        self.wide_embeddings = _layers.Embed(table_size, 1,
                                             dtype=torch.float32,
                                             device=device)
        self.wide_dense = _layers.Dense(num_dense, 1, dtype=torch.float32,
                                        device=device)

    def init_weights(self, generator):
        return _layers.init_weights(self, generator)

    def forward(self, dense, cat):
        # offset each slot into its own region of the fused table
        offsets = torch.arange(self.num_cat, device=cat.device) \
            * self.hash_buckets
        ids = cat.long() + offsets[None, :]
        deep_emb = self.deep_embeddings(ids)               # [B, slots, E]
        h = torch.cat([deep_emb.reshape(deep_emb.shape[0], -1),
                       dense.to(self.dtype)], dim=-1)
        for name in self.mlp:
            h = F.relu(getattr(self, name)(h))
        deep_logit = self.deep_head(h)
        wide_logit = self.wide_embeddings(ids).sum(dim=(1, 2))[:, None]
        wide_logit = wide_logit + self.wide_dense(dense)
        return (deep_logit + wide_logit).squeeze(-1)      # [B] logits


class QuantizedEmbed(nn.Module):
    """int8 embedding lookup: per-row symmetric scales, dequantized on
    the gather (``table [N, E]`` int8 and ``scale [N, 1]`` float32, both
    buffers)."""

    def __init__(self, num_embeddings, features, dtype=torch.bfloat16,
                 device=None):
        super(QuantizedEmbed, self).__init__()
        self.dtype = dtype
        self.register_buffer("table", torch.zeros(
            (num_embeddings, features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            (num_embeddings, 1), dtype=torch.float32, device=device))

    def forward(self, ids):
        rows = self.table[ids]
        s = self.scale[ids]
        return rows.to(self.dtype) * s.to(self.dtype)


def quantize_embeddings(state_dict):
    """A trained ``WideDeep`` ``state_dict`` -> ``(slim, quant)``.

    Per-row symmetric int8: ``scale = max(|row|) / 127``, ``q =
    round(row / scale)``. Only the deep table leaves ``slim``; ``quant``
    holds ``deep_embeddings.table`` and ``deep_embeddings.scale``. A
    ``WideDeep(quantized=True)`` loads ``{**slim, **quant}``."""
    slim = {k: v for k, v in state_dict.items()
            if not k.startswith("deep_embeddings.")}
    w = state_dict["deep_embeddings.weight"].float()
    scale = torch.clamp(w.abs().amax(dim=1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return slim, {"deep_embeddings.table": q,
                  "deep_embeddings.scale": scale}


def ctr_loss(logits, batch):
    """Sigmoid cross-entropy against ``batch['label']`` in {0, 1}."""
    return F.binary_cross_entropy_with_logits(
        logits.float(), batch["label"].float())


def hash_categorical(values, buckets):
    """Host-side (ETL) stable string/int -> bucket hashing for the 26
    Criteo slots: crc32 (zlib) per value, stable across runs and
    processes."""
    import zlib

    import numpy as np

    out = np.empty(len(values), np.int64)
    for i, v in enumerate(values):
        out[i] = zlib.crc32(str(v).encode("utf-8")) % buckets
    return out

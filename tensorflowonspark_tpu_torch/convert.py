"""Weight bridge: flax ``DecoderLM`` params <-> the port's ``state_dict``.

The flax tree (a nested dict of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives it) is laid out as the JAX
package's ``models/decoder.py`` builds it:

- ``tok_embed/embedding [V, H]``, ``pos_embed [max_len, H]``;
- per block ``block_i``: ``ln1``/``ln2`` ``scale``/``bias [H]``;
  ``attn/query|key|value`` ``DenseGeneral`` kernels ``[H, N, D]`` with
  bias ``[N, D]``; ``attn/out`` kernel ``[N, D, H]`` with bias ``[H]``;
  ``mlp_in`` ``[H, 4H]`` and ``mlp_out`` ``[4H, H]`` ``Dense`` kernels;
- ``ln_f`` and ``head`` (``[H, V]``).

The port stores the attention projections as ``nn.Linear`` over the
flattened ``N * D`` and every ``Dense`` kernel transposed (torch keeps
``[out, in]``). Every mapping is a reshape or a transpose, so the
round trip is bitwise.
"""

import collections

import numpy as np
import torch

_LN = ("ln1", "ln2")
_QKV = ("query", "key", "value")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _n(t):
    return t.detach().cpu().numpy().copy()


def num_layers_of(params):
    """Blocks in a flax DecoderLM tree (``block_0`` .. ``block_{L-1}``)."""
    n = 0
    while "block_%d" % n in params:
        n += 1
    return n


def from_flax(params):
    """flax ``DecoderLM`` params -> the port DecoderLM's ``state_dict``
    (float32 CPU tensors; load it with ``model.load_state_dict``)."""
    sd = collections.OrderedDict()
    sd["tok_embed.weight"] = _t(params["tok_embed"]["embedding"])
    sd["pos_embed"] = _t(params["pos_embed"])
    for i in range(num_layers_of(params)):
        blk = params["block_%d" % i]
        pre = "blocks.%d." % i
        for ln in _LN:
            sd[pre + ln + ".weight"] = _t(blk[ln]["scale"])
            sd[pre + ln + ".bias"] = _t(blk[ln]["bias"])
        attn = blk["attn"]
        for name in _QKV:
            kern = np.asarray(attn[name]["kernel"])        # [H, N, D]
            h = kern.shape[0]
            sd[pre + "attn.%s.weight" % name] = _t(kern.reshape(h, -1).T)
            sd[pre + "attn.%s.bias" % name] = _t(
                np.asarray(attn[name]["bias"]).reshape(-1))
        out = np.asarray(attn["out"]["kernel"])            # [N, D, H]
        sd[pre + "attn.out.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        sd[pre + "attn.out.bias"] = _t(attn["out"]["bias"])
        for name in ("mlp_in", "mlp_out"):
            sd[pre + name + ".weight"] = _t(np.asarray(
                blk[name]["kernel"]).T)
            sd[pre + name + ".bias"] = _t(blk[name]["bias"])
    sd["ln_f.weight"] = _t(params["ln_f"]["scale"])
    sd["ln_f.bias"] = _t(params["ln_f"]["bias"])
    sd["head.weight"] = _t(np.asarray(params["head"]["kernel"]).T)
    sd["head.bias"] = _t(params["head"]["bias"])
    return sd


def to_flax(state_dict, num_heads):
    """The port's ``state_dict`` -> a flax ``DecoderLM`` params tree of
    numpy arrays (``num_heads`` splits the flattened ``N * D``)."""
    sd = state_dict
    n_layers = 0
    while "blocks.%d.ln1.weight" % n_layers in sd:
        n_layers += 1
    params = {"tok_embed": {"embedding": _n(sd["tok_embed.weight"])},
              "pos_embed": _n(sd["pos_embed"])}
    for i in range(n_layers):
        pre = "blocks.%d." % i
        blk = {}
        for ln in _LN:
            blk[ln] = {"scale": _n(sd[pre + ln + ".weight"]),
                       "bias": _n(sd[pre + ln + ".bias"])}
        attn = {}
        for name in _QKV:
            w = _n(sd[pre + "attn.%s.weight" % name])      # [N*D, H]
            nd, h = w.shape
            d = nd // num_heads
            attn[name] = {
                "kernel": np.ascontiguousarray(w.T).reshape(h, num_heads, d),
                "bias": _n(sd[pre + "attn.%s.bias" % name]).reshape(
                    num_heads, d)}
        w = _n(sd[pre + "attn.out.weight"])                # [H, N*D]
        h, nd = w.shape
        attn["out"] = {
            "kernel": np.ascontiguousarray(w.T).reshape(
                num_heads, nd // num_heads, h),
            "bias": _n(sd[pre + "attn.out.bias"])}
        blk["attn"] = attn
        for name in ("mlp_in", "mlp_out"):
            blk[name] = {
                "kernel": np.ascontiguousarray(_n(sd[pre + name + ".weight"]).T),
                "bias": _n(sd[pre + name + ".bias"])}
        params["block_%d" % i] = blk
    params["ln_f"] = {"scale": _n(sd["ln_f.weight"]),
                      "bias": _n(sd["ln_f.bias"])}
    params["head"] = {"kernel": np.ascontiguousarray(_n(sd["head.weight"]).T),
                      "bias": _n(sd["head.bias"])}
    return params

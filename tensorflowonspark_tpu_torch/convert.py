"""Weight bridge: flax parameter trees <-> the port's ``state_dict``s.

**The model zoo** (``<family>_from_flax(params, extra=None)`` and
``<family>_to_flax(state_dict)`` for ``lenet``, ``resnet``,
``inception``, ``unet``, ``widedeep`` and ``bert``): the port's zoo
modules carry flax's module names (``BottleneckBlock_3.Conv_1``,
``bert.layer_0.attention.query``), so one walk maps every family:

- a ``Dense`` kernel ``[in, out]`` is transposed to torch's ``[out,
  in]``; a ``Conv`` kernel goes from HWIO to OIHW; a ``ConvTranspose``
  kernel (flax does not flip it) is flipped in space and laid out
  ``[in, out, kh, kw]`` for ``conv_transpose2d``;
- BERT's ``DenseGeneral`` kernels ``[H, N, D]`` (query, key, value; bias
  ``[N, D]``) and ``[N, D, H]`` (out) become ``Linear`` weights over the
  flattened ``N * D``, as the decoder's are;
- ``scale`` (BatchNorm, LayerNorm) and ``embedding`` become ``weight``;
- ``extra["batch_stats"]`` ``mean``/``var`` become the BatchNorm buffers
  ``running_mean``/``running_var``, and ``extra["quant"]`` (Wide &
  Deep's int8 ``table`` and float32 ``scale``) the ``QuantizedEmbed``
  buffers of the same names.

``<family>_to_flax`` returns ``(params, extra)`` (``extra`` holds the
collections present). Every mapping is a reshape, a transpose or a
flip, so each round trip is bitwise.

**The decoder** (:func:`from_flax`, :func:`to_flax`): the flax tree (a
nested dict of numpy arrays, as ``jax.tree.map(np.asarray, params)``
gives it) is laid out as the JAX package's ``models/decoder.py`` builds
it:

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


# -- the model zoo ---------------------------------------------------------

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_STAT_FLAX = {v: k for k, v in _STAT_LEAF.items()}
_QUANT_LEAF = ("table", "scale")
_HEADS_IN = ("query", "key", "value")


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            for item in _walk(v, path + (k,)):
                yield item
        else:
            yield path + (k,), v


def _tensor(a):
    """A CPU tensor of ``a``'s dtype (bitwise: no cast)."""
    return torch.from_numpy(np.array(a, copy=True))


def _is_transpose(mod):
    return mod[-1].startswith("ConvTranspose")


def _is_dense_general(mod):
    return len(mod) >= 2 and mod[-2] == "attention" and (
        mod[-1] in _HEADS_IN or mod[-1] == "out")


def _kernel_to_torch(mod, k):
    if k.ndim == 4:
        if _is_transpose(mod):              # [kh, kw, in, out], unflipped
            return np.flip(k, (0, 1)).transpose(2, 3, 0, 1)
        return k.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    if k.ndim == 3:                         # DenseGeneral
        if mod[-1] == "out":                # [N, D, H]
            return k.reshape(-1, k.shape[-1]).T
        return k.reshape(k.shape[0], -1).T  # [H, N, D]
    return k.T


def tree_from_flax(params, extra=None):
    """A zoo model's flax ``params`` (and ``extra`` collections:
    ``batch_stats``, ``quant``) -> its port ``state_dict`` (CPU tensors
    of the leaves' dtypes; load it with ``model.load_state_dict``)."""
    sd = collections.OrderedDict()
    for path, leaf in _walk(params):
        mod, name = path[:-1], path[-1]
        a = np.asarray(leaf)
        if name == "kernel":
            a = _kernel_to_torch(mod, a)
        elif name == "bias" and a.ndim == 2:  # DenseGeneral [N, D]
            a = a.reshape(-1)
        sd[".".join(mod + (_PARAM_LEAF[name],))] = _tensor(a)
    for coll, tree in (extra or {}).items():
        for path, leaf in _walk(tree):
            if coll == "batch_stats":
                name = _STAT_LEAF[path[-1]]
            elif coll == "quant" and path[-1] in _QUANT_LEAF:
                name = path[-1]
            else:
                raise ValueError("no port buffer for collection {!r} leaf "
                                 "{}".format(coll, "/".join(path)))
            sd[".".join(path[:-1] + (name,))] = _tensor(leaf)
    return sd


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tree_to_flax(state_dict, num_heads=None):
    """A zoo model's port ``state_dict`` -> ``(params, extra)``, flax
    trees of numpy arrays; ``num_heads`` splits BERT's flattened
    ``N * D``."""
    params, extra = {}, {}
    for key, t in state_dict.items():
        parts = key.split(".")
        mod, leaf = tuple(parts[:-1]), parts[-1]
        a = _n(t)
        if leaf in _STAT_FLAX:
            _put(extra.setdefault("batch_stats", {}), mod + (
                _STAT_FLAX[leaf],), a)
            continue
        if leaf in _QUANT_LEAF:
            _put(extra.setdefault("quant", {}), mod + (leaf,), a)
            continue
        dense_general = _is_dense_general(mod)
        if dense_general and num_heads is None:
            raise ValueError("{} needs num_heads".format(key))
        if leaf == "bias":
            if dense_general and mod[-1] != "out":
                a = a.reshape(num_heads, -1)
            _put(params, mod + ("bias",), a)
            continue
        if a.ndim == 1:
            name = "scale"
        elif a.ndim == 4:
            name = "kernel"
            if _is_transpose(mod):
                a = np.flip(a.transpose(2, 3, 0, 1), (0, 1))
            else:
                a = a.transpose(2, 3, 1, 0)
        elif mod[-1].endswith("embeddings"):
            name = "embedding"
        else:
            name = "kernel"
            if dense_general and mod[-1] == "out":   # [H, N*D]
                a = a.T.reshape(num_heads, -1, a.shape[0])
            elif dense_general:                       # [N*D, H]
                a = a.T.reshape(a.shape[1], num_heads, -1)
            else:
                a = a.T
        _put(params, mod + (name,), np.ascontiguousarray(a))
    return params, extra


#: each family's bridge is the one walk above (the modules carry
#: flax's names); only BERT's needs the head count back
lenet_from_flax = resnet_from_flax = inception_from_flax = tree_from_flax
unet_from_flax = widedeep_from_flax = bert_from_flax = tree_from_flax
lenet_to_flax = resnet_to_flax = inception_to_flax = tree_to_flax
unet_to_flax = widedeep_to_flax = tree_to_flax


def bert_to_flax(state_dict, num_heads):
    return tree_to_flax(state_dict, num_heads)

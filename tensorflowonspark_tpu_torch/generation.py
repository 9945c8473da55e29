"""Paged prefill/decode step functions and sampling — the port of the
paged half of ``tensorflowonspark_tpu/generation.py``.

The serving engine (serving.DecodeEngine) runs iteration-level batching
over a slot-structured PAGED KV cache, built from three primitives:

- :func:`init_paged_cache` — per layer a K/V block pool ``[kv_blocks
  + 1, block_size, N, D]`` shared by every slot (row 0 is the scratch
  block pad writes land in), with int8 scales beside it for a
  quantized pool. Per-slot cursors and block tables are host state the
  engine passes in on every call.
- :func:`paged_prefill_into_slot` — one request's prompt TAIL (the part
  not covered by shared prefix blocks), padded to a shape bucket, run
  as one batch-1 forward against the shared pool through the slot's
  block-table row; returns the first generated token.
- :func:`paged_decode_step` — one step over every slot at its own
  cursor through its own table row; returns one token per slot.

PyTorch runs eagerly, so there is no per-bucket compile to bound; the
buckets still fix the prefill shapes (and so the kernel's grid) to a
small set. The pools are updated IN PLACE, where the JAX version
returned a new cache pytree.
"""

import torch


def check_sampling_config(temperature, top_k, top_p, generator):
    """Raise ValueError on sampling configs that would serve silently
    wrong tokens (top_k=0 / top_p=0 mask every logit to -inf and emit
    token 0 forever; temperature>0 without a generator has no seeded
    stream)."""
    if temperature and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if top_k is not None and int(top_k) < 1:
        raise ValueError("top_k must be >= 1, got {}".format(top_k))
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError("top_p must be in (0, 1], got {}".format(top_p))


def filter_logits(logits, top_k=None, top_p=None, temperature=0.0):
    """Apply top-k then nucleus filtering to ``[B, V]`` logits.

    Both filters mask by INDEX, not by value threshold (a value cutoff
    keeps every token tied with the boundary logit). ``top_p >= 1.0``
    is an exact no-op. The nucleus keeps the smallest sorted prefix
    whose mass reaches p (the head token always survives); the sort is
    the reference's stable ascending argsort, reversed, so ties order
    the same way."""
    if top_k is not None:
        _, idx_k = torch.topk(logits, int(top_k), dim=-1)
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
            -1, idx_k, True)
        logits = torch.where(keep, logits,
                             torch.full_like(logits, float("-inf")))
    if top_p is not None and top_p < 1.0:
        idx = torch.flip(torch.argsort(logits, dim=-1, stable=True), [-1])
        sorted_logits = torch.gather(logits, -1, idx)
        probs = torch.softmax(sorted_logits / (temperature or 1.0), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p  # mass BEFORE this token
        keep = torch.zeros_like(keep_sorted).scatter_(-1, idx, keep_sorted)
        logits = torch.where(keep, logits,
                             torch.full_like(logits, float("-inf")))
    return logits


def _pick_tokens(logits, generator, temperature, top_k, top_p):
    """``[B, V]`` logits -> ``[B]`` int32 tokens: argmax at temperature
    0, else a draw from ``generator`` (seeded, on the logits' device).
    The draws differ from the reference's PRNG, so sampled streams are
    compared in distribution, never bitwise."""
    logits = filter_logits(logits.float(), top_k=top_k, top_p=top_p,
                           temperature=temperature)
    if temperature:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0] \
            .to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def init_paged_cache(model, slots, total_len, kv_blocks=None,
                     block_size=16, kv_dtype=None, device=None):
    """Fresh paged cache for ``model`` (a port ``DecoderLM``): one dict
    per layer, ``{"cached_key", "cached_value"[, "key_scale",
    "value_scale"]}``. Pools are
    ``[kv_blocks + 1, block_size, N, D]`` (row 0 is scratch) in float32,
    or int8 codes with float32 ``[kv_blocks + 1, block_size, N]`` scales
    (ones, so the zero codes dequantize to exactly zero) when
    ``kv_dtype == "int8"``. ``block_size`` must divide ``total_len``;
    ``kv_blocks`` defaults to capacity parity with a contiguous cache
    (``slots * total_len / block_size``)."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(
            "kv_dtype must be None or 'int8', got {!r}".format(kv_dtype))
    if int(total_len) > model.max_len:
        raise ValueError("total_len {} exceeds model.max_len {}".format(
            total_len, model.max_len))
    if int(block_size) < 1 or int(total_len) % int(block_size):
        raise ValueError("block_size {} must divide total_len {}".format(
            block_size, total_len))
    if kv_blocks is None:
        kv_blocks = int(slots) * (int(total_len) // int(block_size))
    if int(kv_blocks) < 1:
        raise ValueError("kv_blocks must be >= 1, got {}".format(kv_blocks))
    shape = (int(kv_blocks) + 1, int(block_size), model.num_heads,
             model.head_dim)
    quant = kv_dtype == "int8"
    layers = []
    for _ in range(model.num_layers):
        layer = {"cached_key": torch.zeros(
                     shape, dtype=torch.int8 if quant else torch.float32,
                     device=device),
                 "cached_value": torch.zeros(
                     shape, dtype=torch.int8 if quant else torch.float32,
                     device=device)}
        if quant:
            layer["key_scale"] = torch.ones(shape[:3], dtype=torch.float32,
                                            device=device)
            layer["value_scale"] = torch.ones(shape[:3],
                                              dtype=torch.float32,
                                              device=device)
        layers.append(layer)
    return layers


@torch.no_grad()
def paged_prefill_into_slot(model, cache, table_row, tokens, tail_len,
                            start, temperature=0.0, top_k=None, top_p=None,
                            generator=None, attn_impl="fused"):
    """Prefill a prompt TAIL into the pool blocks ``table_row`` maps.

    ``tokens [bucket]`` is the un-shared tail padded to its shape
    bucket; ``tail_len`` its real length; ``start`` the logical position
    the tail begins at (0 cold, the shared-prefix length — a block
    multiple — on a prefix-cache hit). ``table_row [MB]`` int32 is the
    slot's full block table: shared prefix blocks first (read-only
    here: writes start past them), then the private blocks the tail
    writes, then scratch (0) entries that absorb bucket-pad writes.
    Runs as ONE batch-1 forward against the shared pools (updated in
    place) and returns the first generated token, picked from the
    logits at the last real tail position, as an int32 tensor."""
    dev = cache[0]["cached_key"].device
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=dev)[None, :]
    table = torch.as_tensor(table_row, dtype=torch.int32,
                            device=dev)[None, :]
    idx = torch.full((1,), int(start), dtype=torch.int32, device=dev)
    logits = model(toks, cache, idx, table, attn_impl=attn_impl)
    cap = logits[:, int(tail_len) - 1, :]
    return _pick_tokens(cap, generator, temperature, top_k, top_p)[0]


@torch.no_grad()
def paged_decode_step(model, cache, tokens, idx, tables, temperature=0.0,
                      top_k=None, top_p=None, generator=None,
                      attn_impl="fused"):
    """One fixed-shape decode step over every slot: ``tokens [S]`` (each
    slot's last token) written at ``idx [S]`` through ``tables [S, MB]``;
    returns ``[S]`` int32 picks. The host is the authority on cursors
    and tables every call."""
    dev = cache[0]["cached_key"].device
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=dev)[:, None]
    idx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    tables = torch.as_tensor(tables, dtype=torch.int32, device=dev)
    logits = model(toks, cache, idx, tables, attn_impl=attn_impl)
    return _pick_tokens(logits[:, -1, :], generator, temperature, top_k,
                        top_p)


def default_buckets(total_len, lo=8):
    """Power-of-two prompt buckets up to ``total_len``: the prefill
    shapes the engine ever runs."""
    buckets, b = [], max(2, int(lo))
    while b < total_len:
        buckets.append(b)
        b *= 2
    buckets.append(int(total_len))
    return tuple(buckets)


def bucket_for(length, buckets):
    """Smallest bucket >= length (raises if the prompt outgrows them)."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        "prompt length {} exceeds the largest bucket {}".format(
            length, buckets[-1]))

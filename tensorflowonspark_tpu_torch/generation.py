"""Autoregressive generation over a KV cache — the port of
``tensorflowonspark_tpu/generation.py``.

Solo generation: :func:`generate` (``generate_jit`` is the same
function under the reference's name) feeds the prompt one token at a
time into a fresh contiguous cache (:func:`init_cache`: per layer
``[B, L, N, D]`` K/V and a ``[B]`` cursor), then picks ``max_new``
tokens, freezing a row after ``eos_token``. The contiguous slot
primitives (:func:`prefill_into_slot`, :func:`decode_step`) serve the
``kv_block_size=0`` engine.

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

Speculative decoding on the paged pool: a draft (:func:`draft_model`:
the target's embeddings, first ``draft_layers`` blocks, final norm and
head — the same modules, so the weights are tied by identity) proposes
``k`` tokens with ``k`` chained one-token steps
(:func:`paged_propose_tokens`, the kernel's split-KV route), and the
target scores the window ``[last, d_1..d_{k-1}]`` in one ``k``-query
apply (:func:`paged_verify_step`: the window route, the tiled one past 4);
:func:`paged_spec_round` wires the draft's picks into the verify feed
on the device. KV shipping: :func:`gather_block_rows` /
:func:`scatter_block_rows` read and write pool rows as stored (int8
codes with their scales).
"""

import numpy as np
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


def _rank_heads(model):
    """How many heads one rank of ``model`` attends: ``N``, or ``N / tp``
    for a model whose q/k/v weights are split over a mesh
    (``parallel.sharding.head_shards``)."""
    if not _distributed(model):
        return model.num_heads
    from tensorflowonspark_tpu_torch.parallel import sharding

    return model.num_heads // sharding.head_shards(model.blocks[0].attn).tp


def _distributed(model):
    """Whether ``model``'s parameters are DTensors laid out on a mesh
    (``parallel.sharding.distribute_params``)."""
    return getattr(next(model.parameters()), "device_mesh", None) \
        is not None


def init_cache(model, batch, total_len, device=None):
    """Fresh contiguous cache for ``batch`` sequences of up to
    ``total_len`` tokens: per layer ``{"cached_key", "cached_value"}``
    float32 zeros ``[batch, total_len, N, D]`` and ``"cache_index"``, the
    per-row write cursor, int32 zeros ``[batch]`` (on ``device``, else
    the model's). For a model whose heads are split over ``tp`` ranks
    (``DECODER_TP_RULES``), each rank's cache holds its ``N / tp``
    heads."""
    if int(total_len) > model.max_len:
        raise ValueError("total_len {} exceeds model.max_len {}".format(
            total_len, model.max_len))
    dev = device if device is not None else next(model.parameters()).device
    shape = (int(batch), int(total_len), _rank_heads(model),
             model.head_dim)
    return [{"cached_key": torch.zeros(shape, dtype=torch.float32,
                                       device=dev),
             "cached_value": torch.zeros(shape, dtype=torch.float32,
                                         device=dev),
             "cache_index": torch.zeros(int(batch), dtype=torch.int32,
                                        device=dev)}
            for _ in range(model.num_layers)]


@torch.no_grad()
def generate(model, prompt, max_new_tokens, temperature=0.0,
             generator=None, top_k=None, top_p=None, eos_token=None,
             pad_token=0, device=None):
    """``[B, S]`` prompt -> ``[B, S + max_new_tokens]`` int32 tokens.

    Prompts are real tokens of one length (no padding mask). The prompt
    goes in one token at a time (the reference's scan), then each new
    token is picked from the last logits and fed back; the last pick
    needs no forward. Greedy at ``temperature == 0``; otherwise draws
    from ``generator`` (a seeded ``torch.Generator`` on the device).
    ``eos_token`` freezes a row once emitted: its later positions are
    ``pad_token``. Runs on ``device`` (None: the card; ``"cpu"`` must
    be asked for), where the model is moved.

    A model laid out on a mesh (``parallel.sharding.distribute_params``,
    ``DECODER_TP_RULES``) decodes with no other argument: every rank of
    the mesh calls ``generate`` with the same prompt, each keeps its
    heads' cache, and the logits come out replicated. Such a model is
    not moved: its mesh must live on ``device``. Every rank must pick
    the same tokens — at temperature 0 the replicated logits see to
    it; sampling needs each rank's ``generator`` seeded alike, and each
    step's picks are checked across the mesh (an all-reduce of ``2 B``
    int64 a mesh dim), raising if they differ."""
    from tensorflowonspark_tpu_torch import device_info

    dev = device_info.default_device(device)
    distributed = _distributed(model)
    if distributed:
        mesh_dev = next(model.parameters()).device_mesh.device_type
        if torch.device(mesh_dev).type != dev.type:
            raise ValueError(
                "the model's mesh lives on {!r}, generate was asked for "
                "{}: a distributed model is not moved".format(mesh_dev,
                                                              dev))
        model = model.eval()
    else:
        model = model.to(dev).eval()
    prompt = torch.as_tensor(prompt, dtype=torch.int32,
                             device=dev)
    b, s = prompt.shape
    max_new = int(max_new_tokens)
    if max_new < 0:
        raise ValueError(
            "max_new_tokens must be >= 0, got {}".format(max_new_tokens))
    if model.max_len < s + max_new:
        raise ValueError(
            "model.max_len={} < prompt {} + max_new_tokens {}".format(
                model.max_len, s, max_new_tokens))
    check_sampling_config(temperature, top_k, top_p, generator)
    if max_new == 0:
        return prompt
    cache = init_cache(model, b, model.max_len, device=dev)
    forward = cached_forward(model)
    logits = None
    for col in range(s):
        logits = forward(prompt[:, col:col + 1], cache)[:, -1, :]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    new = []
    for step in range(max_new):
        token = _pick_tokens(logits, generator, temperature, top_k, top_p)
        if distributed and temperature:
            _check_same_picks(model, token)
        if eos_token is not None:
            # pick_frozen: a finished row emits pad and stays finished
            token = torch.where(done, torch.full_like(token, pad_token),
                                token)
            done = done | (token == int(eos_token))
        new.append(token)
        if step < max_new - 1:
            logits = forward(token[:, None], cache)[:, -1, :]
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)


def cached_forward(model):
    """``model``'s cached forward ``(tokens, cache) -> logits`` on plain
    tensors: ``model`` itself, or for parameters laid out as DTensors
    (``parallel.sharding.distribute_params``) a wrapper in which the
    plain token and cursor tensors meet them as replicated
    (``implicit_replication``, as the sharded Trainer step runs) and the
    replicated logits come back as this rank's plain tensor."""
    if not _distributed(model):
        return model
    from torch.distributed.tensor.experimental import implicit_replication

    def forward(tokens, cache):
        with implicit_replication():
            logits = model(tokens, cache)
        return logits.to_local() if hasattr(logits, "to_local") else logits

    return forward


def _check_same_picks(model, token):
    """Raise unless every rank of ``model``'s mesh picked ``token``: an
    all-reduce (MAX) of ``[token, -token]`` over each mesh dim, whose
    two halves then agree only when every rank's picks do. All-reduces,
    not an all-gather, so a gloo group over CUDA tensors runs them."""
    import torch.distributed as dist

    mesh = next(model.parameters()).device_mesh
    both = torch.cat([token, -token]).to(torch.int64)
    for dim in range(mesh.ndim):
        if mesh.size(dim) > 1:
            dist.all_reduce(both, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(dim))
    hi, neg_lo = both.chunk(2)
    if not torch.equal(hi, -neg_lo):
        raise RuntimeError(
            "the ranks of the mesh picked different tokens: seed every "
            "rank's generator alike to sample under tensor parallelism")


#: the reference's jitted entry point; eager PyTorch compiles nothing,
#: so it is :func:`generate` itself
generate_jit = generate


def _set_cursor_leaves(cache, idx):
    """Overwrite every layer's ``cache_index`` with ``idx`` (in place):
    the host is the authority on each slot's position, so a freed slot
    does not walk its cursor while it idles."""
    for layer in cache:
        layer["cache_index"].copy_(torch.as_tensor(
            idx, dtype=torch.int32, device=layer["cache_index"].device))
    return cache


@torch.no_grad()
def prefill_into_slot(model, cache, slot, tokens, true_len,
                      temperature=0.0, top_k=None, top_p=None,
                      generator=None):
    """Prefill one prompt, padded to its bucket (``tokens [bucket]``),
    into row ``slot`` of a contiguous ``cache`` as one fused forward
    from position 0, and return the first generated token (int32),
    picked from the logits at ``true_len - 1``. The row is wiped first
    (the reference scatters a fresh mini cache's full rows), and its
    cursor ends at ``true_len``: pad positions' K/V lies past it."""
    dev = cache[0]["cached_key"].device
    slot = int(slot)
    view = []
    for layer in cache:
        layer["cached_key"][slot].zero_()
        layer["cached_value"][slot].zero_()
        view.append({k: v[slot:slot + 1] for k, v in layer.items()})
    toks = torch.as_tensor(tokens, dtype=torch.int32,
                           device=dev)[None, :]
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    logits = model(toks, view, idx)
    for layer in view:
        layer["cache_index"].fill_(int(true_len))
    cap = logits[:, int(true_len) - 1, :]
    return _pick_tokens(cap, generator, temperature, top_k, top_p)[0]


@torch.no_grad()
def decode_step(model, cache, tokens, idx, temperature=0.0, top_k=None,
                top_p=None, generator=None):
    """One fixed-shape step over every row of a contiguous cache:
    ``tokens [S]`` written at ``idx [S]`` (the host's cursors, set
    into the cache first); returns ``[S]`` int32 picks."""
    dev = cache[0]["cached_key"].device
    _set_cursor_leaves(cache, idx)
    toks = torch.as_tensor(tokens, dtype=torch.int32,
                           device=dev)[:, None]
    logits = model(toks, cache)
    return _pick_tokens(logits[:, -1, :], generator, temperature, top_k,
                        top_p)


def slot_step_fns(model, temperature=0.0, top_k=None, top_p=None):
    """``(prefill, decode)`` for one model and sampling config: the
    contiguous slot primitives with the config bound. A plain function
    pair — eager PyTorch has no compile cache to reuse —
    ``prefill(cache, slot, tokens, true_len, generator)`` and
    ``decode(cache, tokens, idx, generator)``."""
    def prefill(cache, slot, tokens, true_len, generator=None):
        return prefill_into_slot(model, cache, slot, tokens, true_len,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p, generator=generator)

    def decode(cache, tokens, idx, generator=None):
        return decode_step(model, cache, tokens, idx,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, generator=generator)

    return prefill, decode


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


# -- KV block rows, as stored (the device half of disaggregation) -------

#: per-layer pool entries, the shippable content of a paged cache
_POOL_LEAVES = ("cached_key", "cached_value", "key_scale", "value_scale")


def _pool_leaves(cache):
    """``[(wire key, tensor)]`` of every pool entry, keyed by the
    reference's flax path (``block_<i>/attn/<leaf>``) and in its tree
    order (sorted keys), so a shipment's layout is the reference's."""
    out = [("block_{}/attn/{}".format(i, name), layer[name])
           for i, layer in enumerate(cache)
           for name in _POOL_LEAVES if name in layer]
    return sorted(out, key=lambda kv: kv[0])


def gather_block_rows(cache, block_ids):
    """Copy pool rows ``block_ids`` of every pool entry to the host:
    ``[(wire key, numpy rows [len(block_ids), ...])]`` in the entry's
    storage dtype (int8 codes stay int8, scales float32). One
    device-to-host copy per entry; the caller holds the blocks so the
    pool cannot recycle them mid-gather."""
    ids = torch.as_tensor(list(block_ids), dtype=torch.long)
    return [(key, leaf[ids.to(leaf.device)].cpu().numpy())
            for key, leaf in _pool_leaves(cache)]


def scatter_block_rows(cache, block_ids, rows):
    """Write shipped rows (``{wire key: array}`` or the gather's pair
    list) at ``block_ids`` of each path-matched pool entry, in place;
    returns ``cache``. Raises ValueError when the shipment lacks an
    entry or carries another dtype (an fp32 shipment never splices into
    an int8 pool: requantizing would break bitwise parity) or another
    row shape."""
    rows = dict(rows)
    leaves = _pool_leaves(cache)
    for key, leaf in leaves:
        if key not in rows:
            raise ValueError(
                "shipment lacks pool leaf {!r} (incompatible model "
                "config between ship endpoints)".format(key))
        arr = np.asarray(rows[key])
        want = str(leaf.dtype).replace("torch.", "")
        if str(arr.dtype) != want:
            raise ValueError(
                "shipped rows for {!r} are {} but the pool stores {} — "
                "ship endpoints must share kv_dtype".format(
                    key, arr.dtype, want))
        if tuple(arr.shape[1:]) != tuple(leaf.shape[1:]):
            raise ValueError(
                "shipped rows for {!r} have shape {} but the pool's "
                "rows are {}".format(key, tuple(arr.shape[1:]),
                                     tuple(leaf.shape[1:])))
    ids = torch.as_tensor(list(block_ids), dtype=torch.long)
    for key, leaf in leaves:
        # a copy: shipped rows are often read-only views of the wire
        leaf[ids.to(leaf.device)] = torch.from_numpy(
            np.array(rows[key])).to(leaf.device)
    return cache


# -- speculative decoding on the paged pool -----------------------------


def draft_params(params, num_layers_draft):
    """The weight-tied draft's subset of a ``DecoderLM`` state dict:
    the embeddings, blocks ``0..num_layers_draft-1``, the final norm and
    the head — the same tensor objects (aliases, never copies). Raises
    ValueError naming what a non-DecoderLM dict lacks."""
    n = int(num_layers_draft)
    heads = ["tok_embed", "pos_embed", "ln_f", "head"] + [
        "blocks.%d" % i for i in range(n)]
    tied, found = {}, set()
    for key, value in params.items():
        for head in heads:
            if key == head or key.startswith(head + "."):
                tied[key] = value
                found.add(head)
    missing = sorted(set(heads) - found)
    if missing:
        raise ValueError(
            "params lack the DecoderLM-family entries {} needed for a "
            "weight-tied draft".format(missing))
    return tied


def draft_model(model, num_layers_draft):
    """A ``DecoderLM`` of ``num_layers_draft`` blocks whose modules ARE
    ``model``'s: ``tok_embed``, ``pos_embed`` (the same
    ``nn.Parameter``), the first blocks, ``ln_f`` and ``head`` — tied
    by identity, so no copy can drift from the target."""
    n = int(num_layers_draft)
    if not 1 <= n <= model.num_layers:
        raise ValueError(
            "draft_layers must be in [1, num_layers={}], got {}".format(
                model.num_layers, num_layers_draft))
    draft = type(model)(model.vocab, hidden=model.hidden,
                        num_heads=model.num_heads, num_layers=0,
                        max_len=model.max_len, device="meta")
    draft.tok_embed = model.tok_embed
    draft.pos_embed = model.pos_embed
    draft.blocks = torch.nn.ModuleList(list(model.blocks)[:n])
    draft.ln_f = model.ln_f
    draft.head = model.head
    draft.num_layers = n
    return draft.train(model.training)


@torch.no_grad()
def paged_propose_tokens(draft, cache, last, idx, tables, k,
                         temperature=0.0, top_k=None, top_p=None,
                         generator=None, attn_impl="fused"):
    """``k`` chained one-token paged steps of the draft: feed ``last
    [S]``, pick, feed the pick... each writing its K/V through the
    shared ``tables`` at the advancing cursors. Returns ``drafts [S,
    k]`` (int32, on the device): ``drafts[:, j]`` is the pick after the
    j-th fed token, so the fed window is ``[last, d_1..d_{k-1}]``."""
    dev = cache[0]["cached_key"].device
    tok = torch.as_tensor(last, dtype=torch.int32, device=dev)
    cur = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    tables = torch.as_tensor(tables, dtype=torch.int32,
                             device=dev)
    drafts = []
    for _ in range(int(k)):
        logits = draft(tok[:, None], cache, cur, tables,
                       attn_impl=attn_impl)
        tok = _pick_tokens(logits[:, -1, :], generator, temperature,
                           top_k, top_p)
        drafts.append(tok)
        cur = cur + 1
    return torch.stack(drafts, dim=1)


@torch.no_grad()
def paged_verify_step(model, cache, tokens, idx, tables, temperature=0.0,
                      top_k=None, top_p=None, generator=None,
                      attn_impl="fused"):
    """Score a whole window in one target apply: ``tokens [S, k]`` is
    ``[last, d_1..d_{k-1}]`` per slot, written at ``idx + 0..k-1``
    through ``tables``. Returns ``picks [S, k]``, the target's own
    choice after each fed token; acceptance is the host's token match."""
    dev = cache[0]["cached_key"].device
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    idx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    tables = torch.as_tensor(tables, dtype=torch.int32,
                             device=dev)
    logits = model(tokens, cache, idx, tables, attn_impl=attn_impl)
    s, k, v = logits.shape
    return _pick_tokens(logits.reshape(s * k, v), generator, temperature,
                        top_k, top_p).reshape(s, k)


def _split_generator(generator, n):
    """``n`` generators on ``generator``'s device, seeded from draws of
    it: independent streams for a round's draft and verify."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(int(x))
            for x in seeds]


@torch.no_grad()
def paged_spec_round(model, draft, cache, draft_cache, last, idx, tables,
                     k, temperature=0.0, top_k=None, top_p=None,
                     generator=None, attn_impl="fused"):
    """One speculative round: :func:`paged_propose_tokens` on the draft
    cache, then :func:`paged_verify_step` on the target cache, the
    draft's picks wired into the verify feed on the device (no host copy
    between the halves). At temperature > 0 the halves draw from two
    streams split from ``generator``. Returns ``(drafts [S, k],
    targets [S, k])`` on the device."""
    dev = cache[0]["cached_key"].device
    gen_d, gen_v = _split_generator(generator if temperature else None, 2)
    last = torch.as_tensor(last, dtype=torch.int32, device=dev)
    drafts = paged_propose_tokens(draft, draft_cache, last, idx, tables, k,
                                  temperature, top_k, top_p, gen_d,
                                  attn_impl)
    feed = torch.cat([last[:, None], drafts[:, :int(k) - 1]], dim=1)
    targets = paged_verify_step(model, cache, feed, idx, tables,
                                temperature, top_k, top_p, gen_v,
                                attn_impl)
    return drafts, targets


def speculative_probe_fns(model, draft, k, temperature=0.0, top_k=None,
                          top_p=None, attn_impl="fused"):
    """``(propose, verify)``: the two halves of a round, standalone,
    for timing each — ``propose(draft_cache, last, idx, tables,
    generator)`` and ``verify(cache, tokens, idx, tables, generator)``.
    Both write through the tables in place, so a probe runs on copies
    of an engine's pools (``DecodeEngine.measure_spec`` makes them)."""
    def propose(draft_cache, last, idx, tables, generator=None):
        return paged_propose_tokens(draft, draft_cache, last, idx, tables,
                                    k, temperature, top_k, top_p,
                                    generator, attn_impl)

    def verify(cache, tokens, idx, tables, generator=None):
        return paged_verify_step(model, cache, tokens, idx, tables,
                                 temperature, top_k, top_p, generator,
                                 attn_impl)

    return propose, verify


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

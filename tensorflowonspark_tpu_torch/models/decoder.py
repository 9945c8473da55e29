"""Decoder-only causal LM — the port of
``tensorflowonspark_tpu/models/decoder.py``.

GPT-style: learned token and position embeddings, pre-LN blocks with a
4x GELU MLP, a final LayerNorm and an untied head. Two paths, chosen by
whether a cache is passed:

- **full sequence** (``model(tokens)``, training): positions
  ``0..s-1``; each block attends causally through
  ``ops.flash_attention`` when ``s`` is a multiple of 128, else through
  the plain ``_reference`` — the reference's dispatch
  (``decoder.py:289-294``).
- **contiguous cache** (``model(tokens, cache[, idx])``, solo
  ``generation.generate`` and the ``kv_block_size=0`` engine): per
  layer ``[B, L, N, D]`` K/V and a ``cache_index`` ``[B]`` cursor; a
  call writes at each row's cursor and attends the whole row under
  ``arange(L) <= pos``, with two einsums, as the reference does. With
  parameters laid out on a mesh by ``parallel.sharding.DECODER_TP_RULES``
  each rank attends its ``N / tp`` heads in its own ``[B, L, N / tp,
  D]`` cache, and one all-reduce after ``attn.out`` and one after
  ``mlp_out`` make each block's output replicated (the megatron split;
  the paged path refuses such a model).
- **paged decode** (``model(tokens, cache, idx, tables)``, serving):
  every call writes the step's K/V for logical positions ``[idx, idx +
  s)`` through the block table into the layer's pool, then attends
  through the table (``ops.paged_attention``). ``s == 1`` is a decode
  step; ``s > 1`` a prefill tail, cold (``idx == 0``) or continuing
  mid-sequence after a shared prefix.

The cache is plain tensors owned by the caller (generation.py's
:func:`~tensorflowonspark_tpu_torch.generation.init_paged_cache`): per
layer the pools ``cached_key``/``cached_value`` ``[P, bs, N, D]`` and,
for int8 KV, ``key_scale``/``value_scale`` ``[P, bs, N]``; writes
update them in place. Pool row 0 is scratch. A contiguous cache
(:func:`~tensorflowonspark_tpu_torch.generation.init_cache`) holds
``cached_key``/``cached_value`` ``[B, L, N, D]`` and ``cache_index``
``[B]`` per layer, also updated in place.

Three flax defaults are matched explicitly, because torch's differ:
LayerNorm epsilon 1e-6, GELU in its tanh approximation, and the
attention projections as ``DenseGeneral`` contractions over ``(N, D)``
(here ``nn.Linear`` over the flattened ``N * D``; convert.py maps the
kernels).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models._layers import LN_EPS
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.ops import paged_attention as pa

#: "fused": the kernels on the card (plain versions on the CPU);
#: "gather": the plain oracles on any device — paged attention through
#: the materialized view, full-sequence attention through the flash
#: plain versions
ATTN_IMPLS = ("fused", "gather")


class CausalSelfAttention(nn.Module):
    """Causal self-attention: full-sequence, or paged write-then-attend
    when a layer cache is given."""

    def __init__(self, hidden, num_heads, device=None):
        super(CausalSelfAttention, self).__init__()
        if hidden % num_heads:
            raise ValueError(
                "hidden size {} not divisible by num_heads {}".format(
                    hidden, num_heads))
        self.num_heads = num_heads
        self.head_dim = hidden // num_heads
        self.query = nn.Linear(hidden, hidden, device=device)
        self.key = nn.Linear(hidden, hidden, device=device)
        self.value = nn.Linear(hidden, hidden, device=device)
        self.out = nn.Linear(hidden, hidden, device=device)

    def forward(self, x, layer_cache=None, pos=None, tables=None,
                attn_impl="fused"):
        if attn_impl not in ATTN_IMPLS:
            raise ValueError("attn_impl must be 'fused' or 'gather', got "
                             "{!r}".format(attn_impl))
        b, s, h = x.shape
        n, d = self.num_heads, self.head_dim
        if layer_cache is not None and _distributed(self.query.weight):
            if tables is not None:
                raise ValueError(
                    "the paged cache does not take a tensor-parallel "
                    "model: TP decode runs through the contiguous cache "
                    "(generation.generate); TP through the paged engine "
                    "is not in the reference")
            return self._contiguous_sharded(x, layer_cache, pos)
        q = self.query(x).view(b, s, n, d)
        k = self.key(x).view(b, s, n, d)
        v = self.value(x).view(b, s, n, d)
        if layer_cache is None:
            if s % fa.DEFAULT_BLOCK_Q == 0:
                ctx = fa.flash_attention(
                    q, k, v, causal=True,
                    impl=None if attn_impl == "fused" else "plain")
            else:
                # the reference's dispatch: lengths the kernel's blocks
                # do not divide take the exact plain attention
                ctx = fa._reference(q, k, v, True, d ** -0.5)
            return self.out(ctx.reshape(b, s, n * d))
        if tables is None:
            return self.out(self._contiguous(q, k, v, layer_cache, pos)
                            .reshape(b, s, n * d))
        pk = layer_cache["cached_key"]
        pv = layer_cache["cached_value"]
        bs_blk = pk.shape[1]
        mb = tables.shape[1]
        blk_idx = (pos // bs_blk).long()                      # [B, s]
        blk = torch.gather(tables, 1, blk_idx.clamp(max=mb - 1)).long()
        # positions past the table's capacity (bucket-padded prefill
        # tails) write to the scratch row 0: a clamped write would land
        # on a visible offset of whatever block the last entry holds
        blk = torch.where(blk_idx < mb, blk, torch.zeros_like(blk))
        off = (pos % bs_blk).long()
        ksc = layer_cache.get("key_scale")
        vsc = layer_cache.get("value_scale")
        if ksc is not None:
            # int8 KV: quantize at write time, codes and scales routed
            # through the same (block, offset) as float K/V would be
            qk, sk = pa.quantize_kv(k)
            qv, sv = pa.quantize_kv(v)
            pk[blk, off] = qk
            pv[blk, off] = qv
            ksc[blk, off] = sk
            vsc[blk, off] = sv
        else:
            pk[blk, off] = k.to(pk.dtype)
            pv[blk, off] = v.to(pv.dtype)
        ctx = pa.paged_attention(
            q, pk, pv, tables, pos, scale=d ** -0.5,
            impl=None if attn_impl == "fused" else "gather",
            k_scale=ksc, v_scale=vsc)
        return self.out(ctx.reshape(b, s, n * d))


    def _contiguous_sharded(self, x, layer_cache, pos):
        """The contiguous cached branch for parameters laid out as
        DTensors (``parallel.sharding.distribute_params`` with
        ``DECODER_TP_RULES``), in the megatron pattern: the sharded
        ``query`` / ``key`` / ``value`` give this rank's ``N / tp``
        heads (the local part of their ``Shard(-1)`` outputs), which
        are written and attended in this rank's ``[B, L, N / tp, D]``
        cache by :meth:`_contiguous`; the context re-enters DTensor
        sharded on its heads, so ``out`` (its columns sharded) makes a
        partial sum that one all-reduce makes replicated. With ``tp``
        1 (q/k/v replicated) every rank attends all heads."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from tensorflowonspark_tpu_torch.parallel import sharding

        lay = sharding.head_shards(self)
        b, s, _ = x.shape
        n, d = self.num_heads // lay.tp, self.head_dim
        mesh = self.query.weight.device_mesh
        heads = [Replicate()] * mesh.ndim
        if lay.dim is not None:
            heads[lay.dim] = Shard(2)
        q, k, v = (_local_heads(proj(x), heads).reshape(b, s, n, d)
                   for proj in (self.query, self.key, self.value))
        ctx = self._contiguous(q, k, v, layer_cache, pos)
        return self.out(DTensor.from_local(ctx.reshape(b, s, n * d), mesh,
                                           heads, run_check=False))

    def _contiguous(self, q, k, v, layer_cache, pos):
        """The reference's two unpaged cached branches
        (``decoder.py:232-285``) as one: write this call's K/V at each
        row's positions ``pos [B, s]`` of the ``[B, L, N, D]`` cache, then
        attend over the whole cache under ``arange(L) <= pos`` (the
        ``[B, L]`` mask of a one-token step is the ``s == 1`` case of the
        ``[B, s, L]`` one). Two einsums, no kernel, as in the reference:
        masked logits are float32's lowest finite value, and the
        probabilities are cast to the cache dtype before the second
        product. Writes past ``L`` are dropped, as JAX's scatter drops
        them."""
        ck = layer_cache["cached_key"]
        cv = layer_cache["cached_value"]
        if ck.shape[2] != q.shape[2]:
            raise ValueError(
                "the cache holds {} heads a layer where this rank attends "
                "{}: size it with generation.init_cache on the model as "
                "laid out".format(ck.shape[2], q.shape[2]))
        b, s = pos.shape
        max_len = ck.shape[1]
        rows = torch.arange(b, device=pos.device)[:, None].expand(b, s)
        keep = pos < max_len
        p = pos.long()
        ck[rows[keep], p[keep]] = k[keep].to(ck.dtype)
        cv[rows[keep], p[keep]] = v[keep].to(cv.dtype)
        logits = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32),
                              ck.to(torch.float32)) * q.shape[-1] ** -0.5
        visible = (torch.arange(max_len, device=pos.device)[None, None, :]
                   <= pos[:, :, None])                   # [B, s, L]
        logits = torch.where(visible[:, None, :, :], logits,
                             torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(cv.dtype)
        return torch.einsum("bnqk,bknd->bqnd", probs, cv).to(q.dtype)


def _distributed(weight):
    """Whether ``weight`` is a DTensor (laid out on a mesh)."""
    return getattr(weight, "device_mesh", None) is not None


def _local_heads(y, placements):
    """This rank's part of a q/k/v projection ``y`` (a DTensor): its
    local tensor, once its placements are the expected head split."""
    if tuple(y.placements) != tuple(placements):
        raise ValueError("a q/k/v projection came out as {}, not the head "
                         "split {}".format(tuple(y.placements),
                                           tuple(placements)))
    return y.to_local()


class DecoderBlock(nn.Module):
    def __init__(self, hidden, num_heads, device=None):
        super(DecoderBlock, self).__init__()
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.attn = CausalSelfAttention(hidden, num_heads, device=device)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.mlp_in = nn.Linear(hidden, 4 * hidden, device=device)
        self.mlp_out = nn.Linear(4 * hidden, hidden, device=device)

    def forward(self, x, layer_cache=None, pos=None, tables=None,
                attn_impl="fused"):
        x = x + self.attn(self.ln1(x), layer_cache, pos, tables,
                          attn_impl=attn_impl)
        y = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(y)


class DecoderLM(nn.Module):
    """GPT-style LM: learned positions, pre-LN blocks, untied head."""

    def __init__(self, vocab, hidden=64, num_heads=4, num_layers=2,
                 max_len=512, device=None):
        super(DecoderLM, self).__init__()
        self.vocab = int(vocab)
        self.hidden = int(hidden)
        self.num_heads = int(num_heads)
        self.num_layers = int(num_layers)
        self.max_len = int(max_len)
        self.tok_embed = nn.Embedding(vocab, hidden, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(max_len, hidden, device=device))
        self.blocks = nn.ModuleList(
            DecoderBlock(hidden, num_heads, device=device)
            for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.head = nn.Linear(hidden, vocab, device=device)

    @property
    def head_dim(self):
        return self.hidden // self.num_heads

    def init_weights(self, generator, std=0.02):
        """Random weights from ``generator``: normal(0, ``std``) for
        embeddings and projections, zero biases, unit LayerNorm
        scales. ``generator`` must live on the parameters' device."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif ".ln" in name or name.startswith("ln_f"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, std, generator=generator)
        return self

    def forward(self, tokens, cache_layers=None, idx=None, tables=None,
                attn_impl="fused"):
        """``tokens [B, s]`` -> logits ``[B, s, vocab]``.

        Without ``cache_layers``: the full-sequence forward at positions
        ``0..s-1`` (``s <= max_len``). With them: the cached path at
        positions ``idx[b] + 0..s-1`` (``idx [B]`` int32 per-row
        cursors), writing the step's K/V into ``cache_layers`` — through
        ``tables [B, MB]`` int32 into block pools (paged), or, with
        ``tables`` None, into per-row ``[B, L, N, D]`` caches
        (contiguous; ``idx`` None reads each layer's ``cache_index``
        cursor, and every call advances it by ``s``, as the reference's
        cache collection does)."""
        b, s = tokens.shape
        if cache_layers is None:
            if s > self.max_len:
                raise ValueError("sequence length {} exceeds max_len "
                                 "{}".format(s, self.max_len))
            x = self.tok_embed(tokens.long()) + self.pos_embed[:s][None]
            for block in self.blocks:
                x = block(x, attn_impl=attn_impl)
            return self.head(self.ln_f(x))
        contiguous = tables is None
        if contiguous and idx is None:
            idx = cache_layers[0]["cache_index"]
        pos = idx.to(torch.int32)[:, None] + torch.arange(
            s, dtype=torch.int32, device=tokens.device)[None, :]
        # clamped lookup (the reference's mode="clip"): bucket-pad rows
        # past max_len get a finite embedding; their K/V is invisible,
        # and a non-finite one would poison attention through 0 * NaN
        x = self.tok_embed(tokens.long()) \
            + self.pos_embed[pos.clamp(0, self.max_len - 1).long()]
        for block, layer in zip(self.blocks, cache_layers):
            x = block(x, layer, pos, tables, attn_impl=attn_impl)
        if contiguous:
            nxt = (pos[:, 0] + s).to(torch.int32)
            for layer in cache_layers:
                layer["cache_index"].copy_(nxt)
        return self.head(self.ln_f(x))

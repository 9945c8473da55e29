"""BERT encoder family (BERT-base default) with the SQuAD QA head — the
port of ``tensorflowonspark_tpu/models/bert.py``.

bfloat16 products with float32 parameters, float32 LayerNorm (flax's
epsilon 1e-6), the tanh GELU, and float32 heads. The attention
projections are flax ``DenseGeneral``s over ``(heads, head_dim)``; here
they are ``Dense`` over the flattened ``N * D`` (``convert.py`` maps the
kernels).

Attention takes the reference's route (``bert.py:85-87``): the flash
kernels (``ops.flash_attention`` with the padding mask as its
``key_mask``; on a CUDA tensor the hand-written kernels, on a CPU tensor
their plain versions) when ``use_flash``, a tile divides the sequence
and attention-probability dropout is inactive (eval mode, or
``dropout_rate == 0``); otherwise the einsum path with the ``-inf``-safe
softmax and dropout on the probabilities. Both give a fully masked row
zeros. ``attn_impl="plain"`` routes the flash path to its plain versions
on any device (the oracle the kernels are held against).

The mode is the module's ``training`` flag (the reference's
``deterministic=not train``); dropout draws from torch's generator,
which ``training.Trainer(dropout_rng=True)`` seeds from the step.
Nothing of the reference is left out.
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import _layers
from tensorflowonspark_tpu_torch.ops import flash_attention as fa


class BertConfig(object):
    """Hyperparameters (defaults = BERT-base uncased)."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout_rate=0.1, dtype=torch.bfloat16,
                 use_flash=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        #: route attention through the flash kernels when possible
        self.use_flash = use_flash


def bert_base():
    return BertConfig()


def bert_tiny(vocab_size=1024):
    """Test-sized config: same code path, seconds to run."""
    return BertConfig(vocab_size=vocab_size, hidden_size=64, num_layers=2,
                      num_heads=2, intermediate_size=128, max_position=128)


def _pick_block(s):
    """Largest flash tile <= 128 dividing the sequence length, or None
    (-> einsum path)."""
    for b in (128, 64, 32, 16, 8):
        if s % b == 0:
            return b
    return None


def _softmax_neginf_safe(logits):
    """Softmax over the last axis where a row of all ``-inf`` gives
    zeros (the flash kernels' convention), not a uniform average."""
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    e = torch.where(torch.isneginf(logits), torch.zeros_like(logits),
                    torch.exp(logits - m))
    denom = e.sum(dim=-1, keepdim=True)
    return e / torch.where(denom == 0.0, torch.ones_like(denom), denom)


class SelfAttention(nn.Module):
    def __init__(self, config, device=None):
        super(SelfAttention, self).__init__()
        cfg = self.config = config
        self.head_dim = cfg.hidden_size // cfg.num_heads
        nd = cfg.num_heads * self.head_dim
        dense = functools.partial(_layers.Dense, dtype=cfg.dtype,
                                  device=device)
        self.query = dense(cfg.hidden_size, nd)
        self.key = dense(cfg.hidden_size, nd)
        self.value = dense(cfg.hidden_size, nd)
        self.out = dense(nd, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, mask, attn_impl=None):
        cfg = self.config
        b, s, _ = x.shape
        n, d = cfg.num_heads, self.head_dim
        # [B, S, H] -> [B, S, N, D]
        q = self.query(x).view(b, s, n, d)
        k = self.key(x).view(b, s, n, d)
        v = self.value(x).view(b, s, n, d)
        scale = d ** -0.5
        block = _pick_block(s)
        if (cfg.use_flash and block is not None
                and (not self.training or cfg.dropout_rate == 0.0)):
            ctx = fa.flash_attention(q, k, v, key_mask=mask, scale=scale,
                                     block_q=block, block_k=block,
                                     impl=attn_impl)
        elif getattr(q, "placements", None) is not None:
            ctx = self._head_major(q, k, v, mask, scale)
        else:
            # [B, N, S, S] logits in float32 (bf16 products are exact in
            # float32), -inf at padded keys
            logits = torch.einsum("bsnd,btnd->bnst", q.float(),
                                  k.float()) * scale
            if mask is not None:
                logits = logits.masked_fill(~mask[:, None, None, :],
                                            float("-inf"))
            probs = _softmax_neginf_safe(logits).to(cfg.dtype)
            probs = self.dropout(probs)
            ctx = torch.einsum("bnst,btnd->bsnd", probs, v)
        return self.out(ctx.reshape(b, s, n * d))

    def _head_major(self, q, k, v, mask, scale):
        """The einsum branch for DTensor q/k/v (``BERT_TP_RULES``), with
        the head axis leading: ``[N, B, S, D]`` batched products fold
        their batch dims from the head axis on, so heads sharded over a
        mesh fold without a redistribution (torch 2.11's DTensor refuses
        to flatten ``[B, N]`` with N sharded, as the einsums' products
        do). The same float32 logits, mask, softmax and dropout."""
        qh, kh, vh = (t.permute(2, 0, 1, 3) for t in (q, k, v))
        logits = torch.matmul(qh.float(),
                              kh.float().transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask[None, :, None, :],
                                        float("-inf"))
        probs = self.dropout(
            _softmax_neginf_safe(logits).to(self.config.dtype))
        return torch.matmul(probs, vh).permute(1, 2, 0, 3)


class TransformerLayer(nn.Module):
    def __init__(self, config, device=None):
        super(TransformerLayer, self).__init__()
        cfg = self.config = config
        h = cfg.hidden_size
        self.attention = SelfAttention(cfg, device=device)
        self.ln_attn = nn.LayerNorm(h, eps=_layers.LN_EPS, device=device)
        self.ffn_in = _layers.Dense(h, cfg.intermediate_size,
                                    dtype=cfg.dtype, device=device)
        self.ffn_out = _layers.Dense(cfg.intermediate_size, h,
                                     dtype=cfg.dtype, device=device)
        self.ln_ffn = nn.LayerNorm(h, eps=_layers.LN_EPS, device=device)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, mask, attn_impl=None):
        attn = self.dropout(_summed(self.attention(x, mask, attn_impl)))
        x = self.ln_attn((x + attn).float())
        h = F.gelu(self.ffn_in(x), approximate="tanh")
        h = self.dropout(_summed(self.ffn_out(h)))
        return self.ln_ffn((x + h).float())


def _summed(y):
    """``y`` with any partial sum over a mesh dim reduced (a DTensor out
    of a TP down-projection, ``BERT_TP_RULES``): dropout has no strategy
    for a partial sum, and the residual add would reduce it next anyway,
    so this moves no extra bytes. Anything else comes back as it is."""
    placements = getattr(y, "placements", None)
    if not placements or not any(p.is_partial() for p in placements):
        return y
    from torch.distributed.tensor import Replicate

    return y.redistribute(placements=[Replicate() if p.is_partial() else p
                                      for p in placements])


class BertEncoder(nn.Module):
    """Token/position/type embeddings + N transformer layers."""

    def __init__(self, config, device=None):
        super(BertEncoder, self).__init__()
        cfg = self.config = config
        embed = functools.partial(_layers.Embed, features=cfg.hidden_size,
                                  dtype=cfg.dtype, device=device)
        self.word_embeddings = embed(cfg.vocab_size)
        self.position_embeddings = embed(cfg.max_position)
        self.type_embeddings = embed(cfg.type_vocab_size)
        self.ln_embed = nn.LayerNorm(cfg.hidden_size, eps=_layers.LN_EPS,
                                     device=device)
        self.dropout = nn.Dropout(cfg.dropout_rate)
        self.layers = ["layer_%d" % i for i in range(cfg.num_layers)]
        for name in self.layers:
            self.add_module(name, TransformerLayer(cfg, device=device))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                attn_impl=None):
        b, s = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) \
            + self.position_embeddings(pos) \
            + self.type_embeddings(token_type_ids)
        x = self.dropout(self.ln_embed(x.float()))
        if attention_mask is None:
            mask = torch.ones((b, s), dtype=torch.bool,
                              device=input_ids.device)
        else:
            mask = attention_mask.bool()
        for name in self.layers:
            x = getattr(self, name)(x, mask, attn_impl)
        return x


class BertForQuestionAnswering(nn.Module):
    """Encoder + span head: ``(start_logits, end_logits)`` for SQuAD."""

    def __init__(self, config, device=None):
        super(BertForQuestionAnswering, self).__init__()
        self.config = config
        self.bert = BertEncoder(config, device=device)
        self.qa_outputs = _layers.Dense(config.hidden_size, 2,
                                        dtype=torch.float32, device=device)

    def init_weights(self, generator):
        return _layers.init_weights(self, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                attn_impl=None):
        x = self.bert(input_ids, attention_mask, token_type_ids, attn_impl)
        logits = self.qa_outputs(x)
        return logits[..., 0], logits[..., 1]


class BertForSequenceClassification(nn.Module):
    """Encoder + [CLS] pooler + classifier head."""

    def __init__(self, config, num_classes=2, device=None):
        super(BertForSequenceClassification, self).__init__()
        self.config = config
        self.num_classes = num_classes
        self.bert = BertEncoder(config, device=device)
        self.pooler = _layers.Dense(config.hidden_size, config.hidden_size,
                                    dtype=torch.float32, device=device)
        self.classifier = _layers.Dense(config.hidden_size, num_classes,
                                        dtype=torch.float32, device=device)

    def init_weights(self, generator):
        return _layers.init_weights(self, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                attn_impl=None):
        x = self.bert(input_ids, attention_mask, token_type_ids, attn_impl)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled)


def qa_span_loss(logits, batch):
    """Mean start+end cross-entropy; batch carries start/end positions."""
    start_logits, end_logits = logits
    start = F.cross_entropy(start_logits.float(),
                            batch["start_positions"].long())
    end = F.cross_entropy(end_logits.float(), batch["end_positions"].long())
    return (start + end) / 2.0

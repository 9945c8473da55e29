"""Long-context causal LM trained with sequence-parallel ring+flash — the
port's copy of ``examples/longcontext/long_dist.py``.

The long-context capability demo (SURVEY.md §5 "Long-context/SP"; the
reference has no analog): a small causal transformer whose attention is
``ring_flash_attention`` — the sequence dimension sharded over a ``seq``
mesh axis of ranks (one card each), KV blocks rotating between ranks,
each block update running the port's flash kernels. Peak attention
memory is O(S/P) per rank in BOTH the global and local dimensions, so
context length scales with the ring size.

Synthetic task: next-token prediction on periodic sequences (period <<
seq_len), learnable only by attending far back — a loss drop proves the
long-range path works, not just compiles.

Float32 throughout, as the reference's flax modules are (no ``dtype``
given); flax's default initialisers (``models._layers.init_weights``)
from a seeded ``torch.Generator``.
"""

import functools
import time

import numpy as np


@functools.lru_cache(maxsize=None)
def _model_classes():
    """The modules, defined at first use: like every example driver,
    this one imports torch only inside its functions."""
    import torch.nn as nn
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.models import _layers
    from tensorflowonspark_tpu_torch.parallel.ring_attention import (
        ring_flash_attention)

    class LongSelfAttention(nn.Module):
        """Causal self-attention over a seq-sharded mesh axis: the flax
        ``DenseGeneral`` projections over ``(heads, head_dim)`` are
        ``Linear``s over the fused ``N * D``."""

        def __init__(self, hidden, num_heads, mesh, seq_axis="seq",
                     block=128, layout="contiguous", impl=None):
            super(LongSelfAttention, self).__init__()
            self.num_heads = num_heads
            self.mesh = mesh
            self.seq_axis = seq_axis
            self.block = block
            #: "zigzag": inputs are in the to_zigzag permutation and every
            #: ring step does balanced causal work
            #: (parallel/ring_attention)
            self.layout = layout
            self.impl = impl
            self.query = nn.Linear(hidden, hidden)
            self.key = nn.Linear(hidden, hidden)
            self.value = nn.Linear(hidden, hidden)
            self.out = nn.Linear(hidden, hidden)

        def forward(self, x):
            b, s, h = x.shape
            n = self.num_heads
            q, k, v = (proj(x).view(b, s, n, h // n)
                       for proj in (self.query, self.key, self.value))
            ctx = ring_flash_attention(
                q, k, v, self.mesh, seq_axis=self.seq_axis, causal=True,
                block_q=self.block, block_k=self.block, layout=self.layout,
                impl=self.impl)
            return self.out(ctx.reshape(b, s, h))

    class LongLM(nn.Module):
        """Tiny decoder-only LM; attention is sequence-parallel
        ring+flash. No positional embedding: the causal ring is the only
        position-sensitive op, which is what makes the zigzag permutation
        of its inputs valid."""

        def __init__(self, vocab, hidden, num_heads, num_layers, mesh,
                     block=128, layout="contiguous", impl=None):
            super(LongLM, self).__init__()
            self.num_layers = num_layers
            self.embed = nn.Embedding(vocab, hidden)
            for i in range(num_layers):
                self.add_module("ln_a%d" % i, nn.LayerNorm(
                    hidden, eps=_layers.LN_EPS))
                self.add_module("attn_%d" % i, LongSelfAttention(
                    hidden, num_heads, mesh, block=block, layout=layout,
                    impl=impl))
                self.add_module("ln_m%d" % i, nn.LayerNorm(
                    hidden, eps=_layers.LN_EPS))
                self.add_module("mlp_in%d" % i, nn.Linear(hidden,
                                                          hidden * 4))
                self.add_module("mlp_out%d" % i, nn.Linear(hidden * 4,
                                                           hidden))
            self.ln_f = nn.LayerNorm(hidden, eps=_layers.LN_EPS)
            self.lm_head = nn.Linear(hidden, vocab)

        def init_weights(self, generator):
            return _layers.init_weights(self, generator)

        def forward(self, tokens):
            x = self.embed(tokens.long())
            for i in range(self.num_layers):
                layer = self._modules
                x = x + layer["attn_%d" % i](layer["ln_a%d" % i](x))
                m = layer["mlp_in%d" % i](layer["ln_m%d" % i](x))
                x = x + layer["mlp_out%d" % i](
                    F.gelu(m, approximate="tanh"))
            return self.lm_head(self.ln_f(x))

    return {"LongSelfAttention": LongSelfAttention, "LongLM": LongLM}


def __getattr__(name):
    """``LongSelfAttention`` and ``LongLM``, built at first access."""
    if name in ("LongSelfAttention", "LongLM"):
        return _model_classes()[name]
    raise AttributeError(name)


def periodic_batch(rng, batch, seq_len, vocab, period):
    """Sequences that repeat with ``period``: the only way to predict
    token t is to look back period steps — long-range by construction."""
    base = rng.randint(0, vocab, size=(batch, period))
    reps = -(-seq_len // period)
    return np.tile(base, (1, reps))[:, :seq_len].astype(np.int32)


def train(seq_len=1024, batch=2, vocab=64, hidden=64, heads=2, layers=2,
          period=37, steps=30, lr=3e-3, block=None, log_every=10,
          layout="contiguous", device=None, impl=None, stats=None):
    """Returns (first_loss, last_loss); last << first proves learning.

    The ``seq`` axis spans the ranks of the process group (one card a
    rank; :func:`parallel.build_mesh` starts a one-rank group when none
    is initialized, so one process trains alone); each rank holds its
    ``seq_len / P`` tokens and targets. The loss is the mean over all
    tokens; each rank's gradients (its tokens' terms, plus what the
    ring's backward sent back for its K/V blocks) are averaged over the
    axis, the reference's replicated-parameter update. ``device``: the
    rank's card unless ``"cpu"``.

    ``layout="zigzag"``: tokens and targets are pre-permuted with
    ``to_zigzag`` so the residual stream lives in the balanced layout
    end-to-end — valid because the LM has no positional embedding (the
    only position-sensitive op is the causal attention, which the
    zigzag-aware ring handles) and the mean loss is permutation
    invariant. Same model, same loss, ~2x less causal wall time on a
    real ring.

    ``stats``: a dict to fill with every step's loss and wall seconds,
    the flash kernels this rank launched a step, and the card's peak
    memory (bytes allocated; None on the CPU).
    """
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.parallel import build_mesh
    from tensorflowonspark_tpu_torch.parallel.collectives import axis_of
    from tensorflowonspark_tpu_torch.parallel.ring_attention import (
        to_zigzag)

    dev = device_info.default_device(device)
    mesh = build_mesh({"seq": -1}, device=dev)
    n_dev, rank, group = axis_of(mesh, "seq")
    if seq_len % n_dev:
        raise ValueError("seq_len {} does not divide over {} ranks".format(
            seq_len, n_dev))
    # zigzag: the kernel sees HALF-length sequences per shard
    local = seq_len // n_dev // (2 if layout == "zigzag" else 1)
    block = block or min(128, local)

    model = _model_classes()["LongLM"](
        vocab=vocab, hidden=hidden, num_heads=heads, num_layers=layers,
        mesh=mesh, block=block, layout=layout, impl=impl).to(dev)
    gen = (torch.Generator(device=dev) if dev.type == "cuda"
           else torch.Generator()).manual_seed(0)
    model.init_weights(gen)
    params = list(model.parameters())
    if n_dev > 1:
        for p in params:  # every rank starts from rank 0's weights
            dist.broadcast(p.data, dist.get_global_rank(group, 0),
                           group=group)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(periodic_batch(rng, batch, seq_len + 1, vocab,
                                             period))
    inp, tgt = tokens[:, :seq_len], tokens[:, 1:]
    if layout == "zigzag":
        # permute AFTER the label shift: inputs and targets move to the
        # balanced layout together, so position i still predicts its own
        # next token
        inp, tgt = to_zigzag(inp, n_dev), to_zigzag(tgt, n_dev)
    inp, tgt = (t.chunk(n_dev, dim=1)[rank].contiguous().to(dev)
                for t in (inp, tgt))

    opt = torch.optim.Adam(params, lr=lr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches = dict(fa.launches)
    losses, walls = [], []
    for i in range(steps):
        t0 = time.monotonic()
        opt.zero_grad(set_to_none=True)
        logits = model(inp)
        loss = F.cross_entropy(logits.reshape(-1, vocab).float(),
                               tgt.reshape(-1).long())
        loss.backward()
        loss = loss.detach()
        if n_dev > 1:
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [loss.reshape(1)])
            dist.all_reduce(flat, group=group)
            flat /= n_dev
            off = 0
            for p in params:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
            loss = flat[-1]
        opt.step()
        losses.append(float(loss))  # waits for the step's work
        walls.append(time.monotonic() - t0)
        if log_every and i % log_every == 0 and rank == 0:
            print("step %d loss %.4f" % (i, losses[-1]), flush=True)
    if stats is not None:
        stats.update({
            "losses": losses, "step_s": walls, "ranks": n_dev,
            "layout": layout, "seq_len": seq_len, "batch": batch,
            "flash_launches_per_step": {
                k: (fa.launches[k] - launches[k]) / float(steps)
                for k in launches},
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "device": str(dev)})
    return losses[0], losses[-1]

"""Ring attention: sequence/context parallelism over a mesh axis — the
port of ``tensorflowonspark_tpu/parallel/ring_attention.py``.

Long-context capability the reference lacks entirely (SURVEY.md §5
"Long-context"): sequences sharded over a ``seq`` mesh axis, with KV
blocks rotating around the ring while each rank accumulates attention
for its resident Q shard. Peak memory is O(S/P) per rank, so context
length scales linearly with the ring size.

Layout contract: each rank passes its LOCAL ``[batch, S/P, heads,
head_dim]`` shards of q, k and v (the ``Shard(1)`` layout of the global
``[B, S, N, D]`` arrays) and gets its local output back. Causal masking
uses global positions, so it is exact regardless of ring placement.

What the reference's ``shard_map`` body becomes here:

- **the KV rotation** is :class:`collectives.Shift`, a ``torch.autograd
  .Function``: forward sends the local KV to rank ``i+1`` of the ``seq``
  group and receives from ``i-1`` (one ``batch_isend_irecv``, so a ring
  of two cannot deadlock), backward sends the gradient the other way —
  the transpose JAX's ``ppermute`` gets for free. The rotation after the
  last step is skipped (nothing reads it), so a one-rank ring sends
  nothing. On that path every rank keeps every received block in its
  graph (:class:`collectives.KeepAlive`), so every rank runs every
  shift's backward in the same order even where its causal schedule
  never reads a block; the lockstep ring sends nothing and needs no
  such tie.
- **the per-rank step code** (:func:`_flash_rank`, :func:`_online_rank`)
  takes the rank, the ring size and a ``rotate(t, k, v)`` function; the
  distributed entry points pass the P2P shift, and :func:`_ring_lockstep`
  — the port's counterpart of the JAX tests' virtual CPU devices — runs
  the same code for every rank of a ring in one process, where the
  rotation is an index into the list of shards. That is how one card
  runs a 4-way ring schedule.
- **the block engine** of :func:`ring_flash_attention` is the port's
  ``flash_attention_lse``: on CUDA tensors the hand-written flash
  kernels (forward, dQ, dK/dV), on CPU tensors their plain versions.
  Each step's partial merges through :func:`_merge_partials`, so the
  lse is a real output here and its cotangent reaches every kernel
  backward of the ring (folded into ``delta``).

The merges are elementwise float32 torch ops, as the reference does them
in XLA outside its Pallas kernel. Nothing of the reference is left out;
``ring_flash_attention``'s ``interpret=`` (Pallas's interpreter) has no
counterpart and ``impl="plain"`` takes its place.
"""

import torch

from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.parallel.collectives import (
    KeepAlive, Shift, axis_of)

LAYOUTS = ("contiguous", "zigzag")


#: plain full-sequence attention (the correctness oracle)
reference_attention = fa.reference_attention


def _block_update(q, k, v, m, l, o, q_offset, kv_offset, causal, scale):
    """One online-softmax accumulation step against a KV block."""
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(s_q, device=q.device)
        k_pos = kv_offset + torch.arange(s_k, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~mask[None, None], float("-inf"))
    m_block = s.amax(dim=-1)                            # [b, n, q]
    m_new = torch.maximum(m, m_block)
    # fully-masked rows (causal, early q vs late kv): keep them inert
    safe_m = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                       torch.exp(m - safe_m))
    l_new = l * corr + p.sum(dim=-1)
    o_new = (o * corr[..., None]
             + torch.einsum("bnqk,bknd->bnqd", p.to(v.dtype), v).float())
    return m_new, l_new, o_new


def _logaddexp(a, b):
    """``logaddexp`` whose backward stays finite where both inputs are
    -inf (torch's gives ``exp(-inf - -inf)`` = NaN there): such rows
    take a finite stand-in and are set back to -inf by a ``where``,
    whose backward gives the stand-in a zero gradient."""
    both = torch.isneginf(a) & torch.isneginf(b)
    zero = torch.zeros_like(a)
    lse = torch.logaddexp(torch.where(both, zero, a),
                          torch.where(both, zero, b))
    return torch.where(both, torch.full_like(lse, float("-inf")), lse)


def _merge_partials(out_a, lse_a, out_b, lse_b):
    """Combine two attention partials over disjoint KV sets.

    out: [b, s, n, d]; lse: [b, n, s]. Exact: each partial is a
    normalized softmax-attention over its KV subset with row logsumexp
    lse; reweighting by exp(lse_i - lse_merged) reconstructs the full
    softmax. Fully-masked partials (lse == -inf, out == 0) merge as
    identity; -inf/-inf rows stay inert, with no NaN or inf in the
    forward or the backward.
    """
    lse = _logaddexp(lse_a, lse_b)
    safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)

    def w(l_i):
        return torch.where(torch.isneginf(l_i), torch.zeros_like(l_i),
                           torch.exp(l_i - safe))

    w_a = w(lse_a).permute(0, 2, 1)[..., None]
    w_b = w(lse_b).permute(0, 2, 1)[..., None]
    return out_a * w_a + out_b * w_b, lse


def zigzag_order(axis_size):
    """Half-block placement for the load-balanced causal layout.

    Returns the global half-block index held at each position of the
    zigzag layout: shard ``r`` holds half-blocks ``(r, 2P-1-r)`` — one
    early, one mirrored late — so under causal masking every shard has
    the same amount of live attention work at EVERY ring step, instead
    of early shards idling while late shards bound each step.
    """
    order = []
    for r in range(axis_size):
        order += [r, 2 * axis_size - 1 - r]
    return order


def to_zigzag(x, axis_size, axis=1):
    """Permute a [.., S, ..] global tensor into the zigzag layout (so a
    contiguous ``seq``-sharding gives each shard its early+late pair).
    S must divide by 2*axis_size. Inverse: :func:`from_zigzag`."""
    s = x.shape[axis]
    hb = 2 * axis_size
    if s % hb:
        raise ValueError(
            "sequence {} not divisible by 2*axis_size={}".format(s, hb))
    parts = torch.chunk(x, hb, dim=axis)
    return torch.cat([parts[i] for i in zigzag_order(axis_size)], dim=axis)


def from_zigzag(x, axis_size, axis=1):
    """Inverse of :func:`to_zigzag`."""
    hb = 2 * axis_size
    order = zigzag_order(axis_size)
    inverse = [0] * hb
    for pos, blk in enumerate(order):
        inverse[blk] = pos
    parts = torch.chunk(x, hb, dim=axis)
    return torch.cat([parts[i] for i in inverse], dim=axis)


# -- the rotation ---------------------------------------------------------


def _p2p_rotate(group):
    """``rotate(t, k, v)`` for the ring over ``group``: k, v from rank
    ``i-1`` (:class:`collectives.Shift` by +1)."""
    def rotate(t, k, v):
        return Shift.apply(group, 1, k, v)
    return rotate


# -- the per-rank step code -----------------------------------------------


def _check_ring(s_local, causal, layout, block_q, block_k):
    """The reference's validation; returns the blocks (defaults filled)."""
    block_q = block_q or fa.DEFAULT_BLOCK_Q
    block_k = block_k or fa.DEFAULT_BLOCK_K
    if layout not in LAYOUTS:
        raise ValueError("layout must be 'contiguous' or 'zigzag'")
    if layout == "zigzag" and not causal:
        raise ValueError(
            "zigzag layout only helps (and is only implemented for) "
            "causal attention — non-causal work is already balanced")
    if layout == "zigzag":
        if s_local % 2:
            raise ValueError(
                "zigzag needs an even per-shard length, got {}".format(
                    s_local))
        half = s_local // 2
        if half % block_q or half % block_k:
            # the flash kernel sees HALF-length sequences under zigzag;
            # fail here instead of a confusing kernel assert downstream
            raise ValueError(
                "zigzag half-block length {} must be divisible by "
                "block_q={} and block_k={}".format(half, block_q, block_k))
    return block_q, block_k


def _branch(q_id, kv_id):
    """A (q block, kv block) pair under causal masking, by global block
    order: "full" (kv strictly past), "diag" (the same block) or
    "masked" (kv strictly future: launches nothing)."""
    if kv_id < q_id:
        return "full"
    return "diag" if kv_id == q_id else "masked"


def _flash_rank(q, k, v, rank, ring_size, rotate, causal, scale, block_q,
                block_k, layout, impl):
    """One rank's ring of flash partials (``ring_flash_attention``'s
    ``shard_map`` body). Returns the local output (float32) and the
    rotated k, v blocks, in order."""
    h = q.shape[1] // 2

    def partial(qb, kb, vb, branch):
        o, lse = fa.flash_attention_lse(
            qb, kb, vb, causal=branch == "diag", scale=scale,
            block_q=block_q, block_k=block_k, impl=impl)
        return o.float(), lse

    def merge(acc, o, lse):
        # the first live partial starts the accumulator: merging it into
        # (zeros, -inf) is the identity, bitwise
        return (o, lse) if acc is None else _merge_partials(*acc, o, lse)

    if layout == "zigzag":
        qa, qb = q[:, :h], q[:, h:]
        acc_a = acc_b = None
    else:
        acc = None
    k_cur, v_cur = k, v
    rotated = []
    for t in range(ring_size):
        src = (rank - t) % ring_size
        if layout == "zigzag":
            ka, kb = k_cur[:, :h], k_cur[:, h:]
            va, vb = v_cur[:, :h], v_cur[:, h:]
            # local halves: a = early block (id rank), b = mirrored late
            # block (id 2P-1-rank); the received kv halves carry ids
            # (src, 2P-1-src). qa vs kb is masked for every rank pair
            # (kb is always later); qb vs ka is always fully visible
            branch = _branch(rank, src)
            if branch != "masked":
                acc_a = merge(acc_a, *partial(qa, ka, va, branch))
            acc_b = merge(acc_b, *partial(qb, ka, va, "full"))
            branch = _branch(2 * ring_size - 1 - rank,
                             2 * ring_size - 1 - src)
            if branch != "masked":
                acc_b = merge(acc_b, *partial(qb, kb, vb, branch))
        else:
            branch = _branch(rank, src) if causal else "full"
            if branch != "masked":
                acc = merge(acc, *partial(q, k_cur, v_cur, branch))
        if t + 1 < ring_size:
            k_cur, v_cur = rotate(t, k_cur, v_cur)
            rotated += [k_cur, v_cur]
    if layout == "zigzag":
        return torch.cat([acc_a[0], acc_b[0]], dim=1), rotated
    return acc[0], rotated


def _online_rank(q, k, v, rank, ring_size, rotate, causal, scale):
    """One rank's online-softmax ring (``ring_attention``'s body)."""
    b, s_local, n, d = q.shape
    m = torch.full((b, n, s_local), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n, s_local), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, n, s_local, d), dtype=torch.float32, device=q.device)
    q_offset = rank * s_local
    k_cur, v_cur = k, v
    for t in range(ring_size):
        # every block enters the update (a masked one inertly), so every
        # rotation is in this rank's graph
        src = (rank - t) % ring_size
        m, l, o = _block_update(q, k_cur, v_cur, m, l, o, q_offset,
                                src * s_local, causal, scale)
        if t + 1 < ring_size:
            k_cur, v_cur = rotate(t, k_cur, v_cur)
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # masked rows -> 0
    return torch.einsum("bnqd->bqnd", o / l[..., None]).to(q.dtype)


# -- the entry points -----------------------------------------------------


def ring_flash_attention(q, k, v, mesh, seq_axis="seq", causal=False,
                         scale=None, block_q=None, block_k=None,
                         layout="contiguous", impl=None):
    """Ring attention with the flash kernels as the block engine.

    Same contract and rotation schedule as :func:`ring_attention`, but
    each per-step block update runs ``flash_attention_lse`` (the port's
    flash kernels on CUDA tensors) instead of materializing the
    ``[s_local, s_local]`` score matrix — peak memory O(S/P) per rank in
    the *local* dimension too. Fully differentiable (the kernels'
    ``(out, lse)`` backward, the lse cotangent folded into delta).

    ``q``, ``k``, ``v``: this rank's local ``[B, S/P, N, D]`` shards;
    returns the local output. ``mesh``: a ``DeviceMesh`` with
    ``seq_axis``.

    Causal masking uses the ring's alignment: all blocks are the same
    size and offsets are multiples of s_local, so every (q_shard,
    kv_block) pair is exactly one of fully-visible (kv strictly past),
    diagonal (standard local causal), or fully-masked (kv strictly
    future) — a masked pair launches nothing.

    ``layout="zigzag"`` (causal only): inputs/outputs are in the
    :func:`to_zigzag` permutation — each shard holds an early half-block
    and its mirrored late half-block, so every shard does the SAME
    amount of live work each ring step (three half-length pairs a step,
    one of them masked on some ranks). The contiguous layout's causal
    wall time is bounded by the busiest shard (a full block per step,
    ~2x the average work); zigzag makes each step cost ~one half-block
    pair everywhere, recovering the factor-2.

    ``impl``: the block engine's (None: kernels for CUDA tensors, plain
    versions for CPU tensors; ``"plain"``: the plain versions).
    """
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    block_q, block_k = _check_ring(q.shape[1], causal, layout, block_q,
                                   block_k)
    ring_size, rank, group = axis_of(mesh, seq_axis)
    out, rotated = _flash_rank(q, k, v, rank, ring_size, _p2p_rotate(group),
                               causal, scale, block_q, block_k, layout, impl)
    if rotated and out.requires_grad:
        out = KeepAlive.apply(out, *rotated)
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, seq_axis="seq", causal=False, scale=None):
    """Sequence-parallel attention over ``mesh[seq_axis]`` with the
    online-softmax recurrence in plain torch ops (the reference's
    XLA variant). Takes and returns local ``[B, S/P, N, D]`` shards."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    ring_size, rank, group = axis_of(mesh, seq_axis)
    return _online_rank(q, k, v, rank, ring_size, _p2p_rotate(group), causal,
                        scale)


def _ring_lockstep(q, k, v, ring_size, causal=False, scale=None,
                   block_q=None, block_k=None, layout="contiguous",
                   impl=None, variant="flash"):
    """A ``ring_size``-way ring in one process: the GLOBAL ``[B, S, N,
    D]`` q, k, v are split into ``ring_size`` shards along S, and the
    per-rank step code of :func:`ring_flash_attention` (``variant
    "flash"``) or :func:`ring_attention` (``"online"``) runs for each
    rank in turn, the rotation an index into the list of shards (rank r
    holds shard ``(r - t) % P`` at step t). Returns the global output
    (the ranks' outputs concatenated). Private: the tests and the chip
    smoke run multi-rank schedules through it on one device."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.shape[1] % ring_size:
        raise ValueError("sequence {} not divisible by the ring size "
                         "{}".format(q.shape[1], ring_size))
    qs, ks, vs = (torch.chunk(t, ring_size, dim=1) for t in (q, k, v))
    if variant == "flash":
        block_q, block_k = _check_ring(qs[0].shape[1], causal, layout,
                                       block_q, block_k)
    outs = []
    for r in range(ring_size):
        def rotate(t, k_, v_, r=r):
            src = (r - t - 1) % ring_size
            return ks[src], vs[src]

        if variant == "flash":
            out, _ = _flash_rank(qs[r], ks[r], vs[r], r, ring_size, rotate,
                                 causal, scale, block_q, block_k, layout,
                                 impl)
            outs.append(out.to(q.dtype))
        elif variant == "online":
            outs.append(_online_rank(qs[r], ks[r], vs[r], r, ring_size,
                                     rotate, causal, scale))
        else:
            raise ValueError("variant must be 'flash' or 'online'")
    return torch.cat(outs, dim=1)

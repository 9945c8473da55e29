"""Heads above 256: the wide kernels' schedules and a D-320 decoder, the
port against the JAX package on the CPU.

The JAX package takes any head dim (its Pallas kernels block only the
sequence). On the card the port runs every head dim above 256 on the
kernels of ``csrc/wide_attention.cu``. Its forward kernels (the flash
forward and the paged tiled kernel) compute each score once per CTA: the
four column warps of a row block (or key group) each take a quarter of
every 512-column contraction chunk, sum their partial scores through
shared memory in warp order, and own 128 output columns each of a
512-column group (a grid axis above 512). Its backward and split-KV
kernels make OUTPUT COLUMNS A GRID AXIS: a CTA owns a chunk of output
columns (128 for dQ and dK/dV, ``SPLIT_CHUNK`` for the split kernel)
and sums every score (and the backward's dO V^T) over all of D itself,
32 columns at a time. These tests model those schedules in plain
PyTorch on the CPU — the warps' contraction slices and the order their
partial scores are summed in, the output groups and chunks, the
32-column contraction chunks added in float32, the key (query) tiles in
order and the paged key groups merged at the end, the online softmax in
log2 units, the wide split kernel's splits of ``WIDE_SPLIT_KEYS`` logical
keys and their merge in split order — and hold each model against the
port's plain versions and the JAX package on the same seeded numpy
inputs:

- the flash forward, dQ and dK/dV (dK and dV in CTAs of their own)
  at D 320, 512 and 576 (padded to 384, 512 and 640), causal and
  key-masked, against the Pallas kernels in the interpreter within 2e-4
  (``tests/test_torch_flash_attention.py``'s limit); every output
  group's and column chunk's lse is the same float32 number;
- paged decode and the verify window (1 and 3 queries a row) on the
  split schedule and prefill tails (70 queries, and 12) on the tiled
  one, block 1 and 16, float and int8, at D 300, 512 and 576 (int8 rows
  of 300 codes are not a 16-byte multiple), against the port's gather
  oracle and the JAX gather oracle within the reference's tolerances
  (2e-6, int8 8e-6);
- the slice: ``DecoderLM(vocab 64, hidden 640, num_heads 2, layers 2,
  max_len 256)`` (D 320), its flax params carried over by
  ``convert.from_flax`` and back bitwise, full-sequence logits at S 128
  (the flash branch) within 1e-5, greedy tokens of the contiguous
  ``generate`` and of the paged engines identical to the JAX package's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_flash_attention import TOL as FLASH_TOL
from test_torch_flash_attention import _close, _inputs, _t
from test_torch_head_dim_256 import _jax_pair
from test_torch_cuda_kernel import (WIDE_FWD_ROWS, WIDE_GROUP, WIDE_KEYS,
                                    WIDE_QUERY_TILE, WIDE_SMEM_LIMIT,
                                    wide_fwd_layout, wide_tiled_layout,
                                    wide_tiled_smem_bytes)
from test_torch_paged_attention import FP32_TOL, INT8_TOL, _int8, _jax, _torch

from tensorflowonspark_tpu import generation as jgeneration
from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import convert, generation, serving
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.ops import paged_attention as pa

WIDE_DIMS = [320, 512, 576]
LOG2E = 1.0 / math.log(2.0)
NEG = float("-inf")
#: output columns one CTA of the wide split kernel owns
#: (``csrc/wide_attention.cu`` ``SPLIT_DC``)
SPLIT_CHUNK = 1024
#: the kernels' contraction chunk and key / query tile
DK, TILE = 32, 32


def _chunks(d, width):
    """``(c0, w)``: a row of ``d`` columns cut into chunks of ``width``."""
    return [(c0, min(width, d - c0)) for c0 in range(0, d, width)]


def _chunk_scores(a, b):
    """``a b^T`` over the last dim, one DK-column chunk at a time, each
    chunk's partial added in float32 (``chunk_scores``)."""
    s = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for c0, w in _chunks(a.shape[-1], DK):
        s = s + a[..., c0:c0 + w] @ b[..., c0:c0 + w].transpose(-1, -2)
    return s


def _online(state, x, vals):
    """One tile of the online softmax in log2 units: scores ``x`` [..., K]
    (-inf masked), rows of ``vals`` [..., K, W]; ``state`` (m, l, acc)."""
    m, l, acc = state
    m_new = torch.maximum(m, x.amax(-1))
    safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                       torch.exp2(m - safe))
    p = torch.where(torch.isneginf(x), torch.zeros_like(x),
                    torch.exp2(x - safe[..., None]))
    return m_new, l * corr + p.sum(-1), acc * corr[..., None] + p @ vals


# -- the flash schedule ---------------------------------------------------


def _heads_first(t, dp):
    """[B, S, N, D] -> [B, N, S, Dp] float32, zero-padded to ``dp``."""
    return F.pad(t.float(), (0, dp - t.shape[-1])).permute(0, 2, 1, 3)


def _key_terms(bias, causal, s_q, k0, k1):
    """The additive log2 terms of keys k0..k1 for every query row:
    [B or 1, 1, S_q, K], -inf where masked."""
    cols = torch.arange(k0, k1)
    add = torch.zeros(1, 1, 1, k1 - k0) if bias is None else \
        bias[:, None, None, k0:k1] * LOG2E
    if causal:
        rows = torch.arange(s_q)[:, None]
        add = torch.where(cols[None, :] > rows, torch.full_like(add, NEG),
                          add)
    return add.expand(add.shape[0], 1, s_q, k1 - k0)


def _slices(w):
    """The contraction columns ``(lo, n)`` each of the four column warps
    takes of a chunk ``w`` wide (``warp_slice``): a quarter each, rounded
    up to 16 columns; n <= 0 for none."""
    sl = -(-(-(-w // 4)) // 16) * 16
    return [(c * sl, min(sl, w - c * sl)) for c in range(4)]


def _group_scores(a, b, cw):
    """``a b^T`` as the four column warps of a wide forward CTA compute it:
    each warp sums its slice of every ``cw``-column contraction chunk, in
    chunk order, and the four partials are summed in warp order
    (``sum_partials``)."""
    d = a.shape[-1]
    parts = [torch.zeros(a.shape[:-1] + (b.shape[-2],)) for _ in range(4)]
    for k0, w in _chunks(d, cw):
        for c, (lo, n) in enumerate(_slices(w)):
            if n > 0:
                cols = slice(k0 + lo, k0 + lo + n)
                parts[c] = parts[c] + a[..., cols] @ b[..., cols].transpose(
                    -1, -2)
    return ((parts[0] + parts[1]) + parts[2]) + parts[3]


def _wide_fwd(q, k, v, bias, causal, scale):
    """``flash_wide_fwd_kernel``'s schedule: per 32-query tile and
    512-column output group of the padded D, the 32-key tiles in order up
    to the tile's last visible one, each tile's scores computed once by
    the four column warps (:func:`_group_scores`, the contraction chunk
    :func:`wide_fwd_layout` gives), the online softmax in log2 units,
    acc += P V[:, group]. Returns out [B, S_q, N, D], lse [B, N, S_q] and
    every group's lse."""
    d, s_q, s_k = q.shape[-1], q.shape[1], k.shape[1]
    dp = fa.padded_head_dim(d)
    cw, _ = wide_fwd_layout(dp, torch.float32)
    qh, kh, vh = (_heads_first(t, dp) for t in (q, k, v))
    outs, lses = [], []
    for c0, w in _chunks(dp, WIDE_GROUP):
        out = torch.zeros(qh.shape[:-1] + (w,))
        lse = torch.zeros(qh.shape[:-1])
        for i0 in range(0, s_q, WIDE_FWD_ROWS):
            i1 = min(s_q, i0 + WIDE_FWD_ROWS)
            n_kv = -(-s_k // WIDE_KEYS)
            if causal:
                n_kv = min(n_kv, (i1 - 1) // WIDE_KEYS + 1)
            m = torch.full(qh.shape[:2] + (i1 - i0,), NEG)
            state = (m, torch.zeros_like(m), torch.zeros(m.shape + (w,)))
            for kt in range(n_kv):
                k0, k1 = kt * WIDE_KEYS, min(s_k, (kt + 1) * WIDE_KEYS)
                add = _key_terms(bias, causal, s_q, k0, k1)[:, :, i0:i1]
                s = _group_scores(qh[:, :, i0:i1], kh[:, :, k0:k1], cw) \
                    * (scale * LOG2E)
                x = torch.where(torch.isneginf(add), torch.full_like(s, NEG),
                                s + add)
                state = _online(state, x, vh[:, :, k0:k1, c0:c0 + w])
            m, l, acc = state
            out[:, :, i0:i1] = acc / torch.where(
                l == 0, torch.ones_like(l), l)[..., None]
            lse[:, :, i0:i1] = torch.where(
                l == 0, torch.full_like(l, NEG), (m + torch.log2(l)) / LOG2E)
        outs.append(out)
        lses.append(lse)
    out = torch.cat(outs, -1)[..., :d].permute(0, 2, 1, 3)
    return out, lses[0], lses


def _probs(s, add, lse):
    """P (or P^T) from scores ``s`` in log2 units, the log2 key terms
    ``add`` and the saved lse broadcast to ``s`` (-inf read as 0): 0
    where masked."""
    lse2 = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse)) \
        * LOG2E
    return torch.where(torch.isneginf(add), torch.zeros_like(s),
                       torch.exp2(s + add - lse2))


def _wide_dq(q, k, v, bias, dout, lse, delta, causal, scale):
    """``flash_wide_dq_kernel``'s schedule: per 128-column chunk, per
    32-key tile S = Q K^T and dP = dO V^T over all of D in DK chunks, P
    from the lse, dS = P (dP - delta), dQ += dS K[:, chunk]; times scale."""
    b, s_q, n, d = q.shape
    dp = fa.padded_head_dim(d)
    qh, kh, vh, oh = (_heads_first(t, dp) for t in (q, k, v, dout))
    lse, delta = lse.reshape(b, n, s_q), delta.reshape(b, n, s_q)
    parts = []
    for c0, w in _chunks(dp, fa.WIDE_CHUNK):
        acc = torch.zeros(b, n, s_q, w)
        for k0 in range(0, k.shape[1], TILE):
            k1 = min(k.shape[1], k0 + TILE)
            add = _key_terms(bias, causal, s_q, k0, k1)
            p = _probs(_chunk_scores(qh, kh[:, :, k0:k1]) * (scale * LOG2E),
                       add, lse[..., None])
            ds = p * (_chunk_scores(oh, vh[:, :, k0:k1]) - delta[..., None])
            acc = acc + ds @ kh[:, :, k0:k1, c0:c0 + w]
        parts.append(acc * scale)
    return torch.cat(parts, -1)[..., :d].permute(0, 2, 1, 3)


def _wide_dkv(q, k, v, bias, dout, lse, delta, causal, scale):
    """``flash_wide_dkv_kernel``'s schedule: a CTA a 128-column chunk and
    a role; per 32-query tile S^T = K Q^T over all of D in DK chunks, P^T
    from the lse; the dV role adds P^T dO[:, chunk], the dK role also
    forms dP^T = V dO^T and dS^T and adds dS^T Q[:, chunk] (times
    scale)."""
    b, s_q, n, d = q.shape
    s_k = k.shape[1]
    dp = fa.padded_head_dim(d)
    qh, kh, vh, oh = (_heads_first(t, dp) for t in (q, k, v, dout))
    lse, delta = lse.reshape(b, n, s_q), delta.reshape(b, n, s_q)
    dks, dvs = [], []
    for c0, w in _chunks(dp, fa.WIDE_CHUNK):
        for role in ("dv", "dk"):
            acc = torch.zeros(b, n, s_k, w)
            for q0 in range(0, s_q, TILE):
                q1 = min(s_q, q0 + TILE)
                # the [B, 1, S_q, S_k] key terms of this query tile, as S^T
                add = _key_terms(bias, causal, s_q, 0, s_k)[:, :, q0:q1]
                add = add.transpose(-1, -2)
                st = _chunk_scores(kh, qh[:, :, q0:q1]) * (scale * LOG2E)
                pt = _probs(st, add, lse[..., None, q0:q1])
                if role == "dv":
                    acc = acc + pt @ oh[:, :, q0:q1, c0:c0 + w]
                else:
                    dst = pt * (_chunk_scores(vh, oh[:, :, q0:q1])
                                - delta[..., None, q0:q1])
                    acc = acc + dst @ qh[:, :, q0:q1, c0:c0 + w]
            (dvs if role == "dv" else dks).append(
                acc if role == "dv" else acc * scale)
    back = lambda parts: torch.cat(parts, -1)[..., :d].permute(0, 2, 1, 3)
    return back(dks), back(dvs)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "key_mask"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_flash_schedule_matches_interpreted_kernels(d, causal, masked):
    """The wide kernels' schedules (the forward: 32-query tiles, scores
    once per tile from four warps' partial sums, 512-column output
    groups over the padded D; dQ and dK/dV: column chunks of 128, scores
    summed over all of D in 32-column chunks, 32-key and 32-query tiles,
    dK and dV in CTAs of their own) give the Pallas kernels' out and lse,
    and their gradients through both outputs (a nonzero lse cotangent),
    within 2e-4 at B 2 x S 96 x 2 heads; every output group computes the
    same lse, bit for bit, and a fully masked row has out 0 and lse
    -inf."""
    b, s, n = 2, 96, 2
    q, k, v, mask, g, g_lse = _inputs(b, s, s, n, d, masked, 40 + d)
    (want_out, want_lse), vjp = jax.vjp(
        lambda q, k, v: _jax_pair(q, k, v, mask, causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv, tg = _t(q), _t(k), _t(v), _t(g)
    bias = None if mask is None else fa._mask_to_bias(_t(mask))
    scale = d ** -0.5
    out, lse, lses = _wide_fwd(tq, tk, tv, bias, causal, scale)
    assert len(lses) == -(-fa.padded_head_dim(d) // WIDE_GROUP)
    assert all(torch.equal(x, lses[0]) for x in lses)
    _close(out, want_out, FLASH_TOL)
    _close(lse, want_lse, FLASH_TOL)
    delta = fa._delta(out, tg, _t(g_lse))
    dq = _wide_dq(tq, tk, tv, bias, tg, lse, delta, causal, scale)
    dk, dv = _wide_dkv(tq, tk, tv, bias, tg, lse, delta, causal, scale)
    for got, want in zip((dq, dk, dv), want_grads):
        assert got.shape == tq.shape and torch.isfinite(got).all()
        _close(got, want, FLASH_TOL)
    if masked:
        assert torch.isneginf(lse[-1]).all() and (out[-1] == 0).all()


# -- the paged schedules ------------------------------------------------------


def _wide_case(seed, s_q, d, bs, mb, depths, quant):
    """Pools of distinct rows per row (scratch 0 past each row's live
    blocks), positions ending at ``depths`` (the second row overshooting
    the table's capacity), quantized with the JAX quantizer for int8."""
    rng = np.random.RandomState(seed)
    b = len(depths)
    pool = b * mb + 1
    q = rng.randn(b, s_q, 2, d).astype(np.float32)
    kp = rng.randn(pool, bs, 2, d).astype(np.float32)
    vp = rng.randn(pool, bs, 2, d).astype(np.float32)
    table = (rng.permutation(pool - 1)[:b * mb] + 1).reshape(b, mb)
    pos = (np.array(depths)[:, None] - s_q + np.arange(s_q)[None, :])
    for r in range(b):
        live = min((int(pos[r].max()) + bs) // bs, mb)
        table[r, live:] = 0
    case = (q, kp, vp, table.astype(np.int32), pos.astype(np.int32))
    return _int8(case) if quant else case


def _keys(kp, vp, scales, table_row, keys):
    """Pool rows of logical ``keys`` of one row: K, V [K, N, D] float32
    and their scales [K, N] (ones for float pools)."""
    bs = kp.shape[1]
    blk, row = table_row[keys // bs].long(), keys % bs
    k, v = kp[blk, row].float(), vp[blk, row].float()
    if scales is None:
        ones = torch.ones(k.shape[:2])
        return k, v, ones, ones
    return k, v, scales[0][blk, row], scales[1][blk, row]


def _live(pos_row, bs, mb):
    """Live keys of a row: its highest position's blocks, clamped."""
    return min((int(pos_row.max()) + bs) // bs, mb) * bs


def _wide_split(q, kp, vp, table, pos, scale, scales=None):
    """``paged_wide_split_kernel`` + ``paged_wide_combine_kernel``: per
    row, ceil(table width x block / WIDE_SPLIT_KEYS) splits of that many
    logical keys (those past the row's live keys empty: m -inf, l 0);
    per split and query the dots scaled by the key's scale, in log2 units,
    m, l and acc (p times the value's scale, per SPLIT_CHUNK-column
    chunk); the combine merges the splits in split order. Returns out and
    each row's splits."""
    b, s_q, n, d = q.shape
    bs, mb = kp.shape[1], table.shape[1]
    width = pa.WIDE_SPLIT_KEYS
    out = torch.zeros_like(q)
    rows = []
    for r in range(b):
        pmax = int(pos[r].max())
        kend = min(_live(pos[r], bs, mb), pmax + 1)
        parts = []
        for k_lo in range(0, -(-mb * bs // width) * width, width):
            keys = torch.arange(k_lo, max(k_lo, min(kend, k_lo + width)))
            m = torch.full((s_q, n), NEG)
            l = torch.zeros(s_q, n)
            acc = torch.zeros(s_q, n, d)
            if len(keys):
                k, v, ks, vs = _keys(kp, vp, scales, table[r], keys)
                x = torch.einsum("qnd,knd->qnk", q[r], k) * ks.T[None] \
                    * (scale * LOG2E)
                vis = (keys[None, :] <= pos[r][:, None])[:, None, :]
                x = torch.where(vis, x, torch.full_like(x, NEG))
                m = x.amax(-1)
                safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
                p = torch.where(torch.isneginf(x), torch.zeros_like(x),
                                torch.exp2(x - safe[..., None]))
                l = p.sum(-1)
                pv = p * vs.T[None]
                for c0, w in _chunks(d, SPLIT_CHUNK):
                    acc[..., c0:c0 + w] = torch.einsum(
                        "qnk,knd->qnd", pv, v[..., c0:c0 + w])
            parts.append((m, l, acc))
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        safe = torch.where(torch.isneginf(big), torch.zeros_like(big), big)
        num = torch.zeros(s_q, n, d)
        den = torch.zeros(s_q, n)
        for m, l, acc in parts:
            wgt = torch.where(torch.isneginf(m), torch.zeros_like(m),
                              torch.exp2(m - safe))
            num = num + acc * wgt[..., None]
            den = den + l * wgt
        out[r] = num / torch.where(den == 0, torch.ones_like(den),
                                   den)[..., None]
        rows.append(parts)
    return out, rows


def _wide_tiled(q, kp, vp, table, pos, scale, scales=None):
    """``paged_wide_tiled_kernel``: per 16-query tile of a row and
    512-column output group of D (the last one ragged), the keys up to
    min(live keys, the tile's highest position + 1) in 32-key tiles
    through the table, keys [16 g, 16 g + 16) of each tile taken by key
    group g with an online softmax of its own (log2 units); each tile's
    scores computed once by the group's four column warps
    (:func:`_group_scores` on the raw pool values, the contraction chunk
    of the paged layout, no padding), then times each key's scale (int8),
    P times the value's scale for P V; at the end group 1's (m, l, acc)
    merged into group 0's."""
    b, s_q, n, d = q.shape
    bs, mb = kp.shape[1], table.shape[1]
    quant = scales is not None
    cw, _ = wide_tiled_layout(d, quant)
    half = WIDE_KEYS // 2
    out = torch.zeros_like(q)
    for r in range(b):
        live = _live(pos[r], bs, mb)
        for i0 in range(0, s_q, WIDE_QUERY_TILE):
            qt = q[r, i0:i0 + WIDE_QUERY_TILE].transpose(0, 1)
            pt = pos[r, i0:i0 + WIDE_QUERY_TILE]
            kend = min(live, int(pt.max()) + 1)
            for c0, w in _chunks(d, WIDE_GROUP):
                groups = []
                for kg in range(2):
                    m = torch.full((n, len(pt)), NEG)
                    state = (m, torch.zeros_like(m),
                             torch.zeros(n, len(pt), w))
                    for k0 in range(kg * half, kend, WIDE_KEYS):
                        keys = torch.arange(k0, min(kend, k0 + half))
                        k, v, ks, vs = _keys(kp, vp, scales, table[r], keys)
                        x = _group_scores(qt, k.transpose(0, 1), cw) \
                            * ks.T[:, None, :] * (scale * LOG2E)
                        vis = keys[None, :] <= pt[:, None]
                        x = torch.where(vis[None], x, torch.full_like(x, NEG))
                        vv = (v * vs[..., None]).transpose(0, 1)
                        state = _online(state, x, vv[..., c0:c0 + w])
                    groups.append(state)
                (m0, l0, a0), (m1, l1, a1) = groups
                big = torch.maximum(m0, m1)
                safe = torch.where(torch.isneginf(big), torch.zeros_like(big),
                                   big)
                w0, w1 = (torch.where(torch.isneginf(x), torch.zeros_like(x),
                                      torch.exp2(x - safe)) for x in (m0, m1))
                den = l0 * w0 + l1 * w1
                acc = a0 * w0[..., None] + a1 * w1[..., None]
                out[r, i0:i0 + WIDE_QUERY_TILE, :, c0:c0 + w] = (
                    acc / torch.where(den == 0, torch.ones_like(den),
                                      den)[..., None]).transpose(0, 1)
    return out


def _schedule_inputs(case):
    t = [torch.from_numpy(np.array(a)) for a in case]
    return t[:5], (t[5], t[6]) if len(t) == 7 else None


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [1, 3], ids=["decode", "window"])
@pytest.mark.parametrize("d", [300, 512, 576])
def test_wide_split_schedule_matches_gather_and_jax(d, s_q, quant):
    """Decode and the verify window above 256 as the wide split kernel
    and its combine run them, block 16, a table of 40 blocks (3 splits of
    256 logical keys): a row 600 deep (3 live splits), one overshooting
    the table, one 257 deep (a key past the first split) and one 2 deep
    (its later splits empty: m -inf, l 0, skipped by the merge); against
    the port's gather oracle and the JAX gather oracle."""
    bs, mb = 16, 40
    case = _wide_case(d + s_q, s_q, d, bs, mb,
                      [600, mb * bs + 5, 257, max(2, s_q)], quant)
    (q, kp, vp, table, pos), scales = _schedule_inputs(case)
    got, rows = _wide_split(q, kp, vp, table, pos, d ** -0.5, scales)
    assert all(len(parts) == 3 for parts in rows)
    m, l, _ = rows[3][1]
    assert torch.isneginf(m).all() and (l == 0).all()
    assert torch.isfinite(rows[2][1][0][-1]).all()      # key 256
    tol = INT8_TOL if quant else FP32_TOL
    got = got.numpy()
    np.testing.assert_allclose(got, _torch(case, "gather"), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got, _jax(case, "gather"), atol=tol, rtol=tol)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bs", [1, 16])
@pytest.mark.parametrize("d", [300, 512, 576])
def test_wide_tiled_schedule_matches_gather_and_jax(d, bs, quant):
    """Prefill tails above 256 as the wide tiled kernel runs them: 70
    queries a row (five 16-query tiles, the last ragged), blocks of 1 and
    16 token rows, rows deep in the table, overshooting it and as shallow
    as the tail; D 300 ends in a ragged contraction slice, D 576 in a
    ragged 512-column output group (a second CTA) whose one warp has 64
    columns; against the port's gather oracle and the JAX gather
    oracle."""
    mb = -(-160 // bs)
    case = _wide_case(7 * d + bs, 70, d, bs, mb, [mb * bs - 3, mb * bs + 9,
                                                  70], quant)
    (q, kp, vp, table, pos), scales = _schedule_inputs(case)
    got = _wide_tiled(q, kp, vp, table, pos, d ** -0.5, scales).numpy()
    tol = INT8_TOL if quant else FP32_TOL
    np.testing.assert_allclose(got, _torch(case, "gather"), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got, _jax(case, "gather"), atol=tol, rtol=tol)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [257, 512])
def test_wide_tiled_schedule_short_tail(d, quant):
    """A tail of 12 queries (one ragged 16-query tile, fewer queries than
    a tile) at D 257 and 512, block 16: rows deep in the table and as
    shallow as the tail, and a row whose first key group sees keys the
    second does not; against the port's gather oracle and the JAX gather
    oracle."""
    bs, mb = 16, 10
    case = _wide_case(5 * d + quant, 12, d, bs, mb, [mb * bs - 7, 12, 20],
                      quant)
    (q, kp, vp, table, pos), scales = _schedule_inputs(case)
    got = _wide_tiled(q, kp, vp, table, pos, d ** -0.5, scales).numpy()
    tol = INT8_TOL if quant else FP32_TOL
    np.testing.assert_allclose(got, _torch(case, "gather"), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got, _jax(case, "gather"), atol=tol, rtol=tol)


def test_wide_chunks_cover_every_column_once():
    """The grid's and the warps' column ranges: the forward kernels' output
    groups of 512 and their warps' 128-column chunks, dQ's and dK/dV's
    128-column CTAs (flash on a D padded to a multiple of 128, paged on
    the pool's own D with a ragged last group), 1024 a split CTA; every
    column of D in exactly one of each, and every contraction column in
    exactly one warp's slice of one chunk (512 columns with Q resident,
    256 streamed). The forward kernels' shared memory fits the card at
    every D and dtype; float32 flash holds Q up to D 640 and bfloat16
    up to 2304, the paged kernel up to 1440 (float32) and 2944 (int8)."""
    for d in (257, 300, 384, 512, 576, 640, 768, 1024, 1100, 1440, 1472,
              2304, 2432, 2944, 2976):
        for width in (fa.WIDE_CHUNK, WIDE_GROUP, SPLIT_CHUNK):
            cols = [c for c0, w in _chunks(d, width)
                    for c in range(c0, c0 + w)]
            assert cols == list(range(d))
        groups = [c0 + 128 * j + i for c0, w in _chunks(d, WIDE_GROUP)
                  for j in range(4) if 128 * j < w
                  for i in range(min(128, w - 128 * j))]
        assert groups == list(range(d))
        dp = fa.padded_head_dim(d)
        assert dp % fa.WIDE_CHUNK == 0 and 0 <= dp - d < fa.WIDE_CHUNK
        layouts = [wide_fwd_layout(dp, dt)
                   for dt in (torch.float32, torch.bfloat16)]
        layouts += [wide_tiled_layout(d, quant) for quant in (False,
                                                                 True)]
        for (cw, smem), width in zip(layouts, (dp, dp, d, d)):
            assert cw in (512, 256) and smem <= WIDE_SMEM_LIMIT
            cols = [k0 + lo + i for k0, w in _chunks(width, cw)
                    for lo, n in _slices(w) for i in range(max(n, 0))]
            assert cols == list(range(width))
        assert (layouts[0][0] == 512) == (dp <= 640)
        assert (layouts[1][0] == 512) == (dp <= 2304)
        assert (layouts[2][0] == 512) == (d <= 1440)
        assert (layouts[3][0] == 512) == (d <= 2944)
        for quant in (False, True):
            assert wide_tiled_smem_bytes(d, quant) <= pa.MAX_SMEM_BYTES
    assert len(_chunks(576, SPLIT_CHUNK)) == 1
    assert len(_chunks(1100, SPLIT_CHUNK)) == 2


# -- the slice: a DecoderLM with 320-wide heads ------------------------------

V, H, NH, L, T = 64, 640, 2, 2, 256      # head dim 320
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def flax_params():
    m = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    p = m.init(jax.random.PRNGKey(23), jnp.zeros((1, T), jnp.int32))
    return jax.tree.map(np.asarray, p["params"])


def _port_model(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    m.load_state_dict(convert.from_flax(params))
    return m


def test_convert_carries_heads_above_256_bitwise(flax_params):
    """``convert`` carries a D-320 ``DecoderLM`` to the port and back bit
    for bit, dtypes kept, with no missing or unexpected key."""
    sd = convert.from_flax(flax_params)
    assert sd["blocks.0.attn.query.weight"].shape == (H, H)
    back = convert.to_flax(sd, NH)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(flax_params)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))
        assert flat[path].dtype == leaf.dtype
    assert _port_model(flax_params).blocks[0].attn.head_dim == 320


def test_heads_above_256_logits_match_reference(flax_params):
    """Full-sequence logits at S 128 (the flash branch of both models)."""
    tokens = np.random.RandomState(8).randint(0, V, (2, 128)).astype(
        np.int32)
    jm = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    want = np.asarray(jm.apply({"params": flax_params}, tokens))
    with torch.no_grad():
        got = _port_model(flax_params).eval()(torch.from_numpy(tokens))
    assert got.shape == (2, 128, V)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_heads_above_256_generate_matches_reference(flax_params):
    """Greedy tokens of the contiguous path: the port's ``generate`` and
    the JAX package's on the same prompt, 12 new tokens."""
    prompt = np.random.RandomState(9).randint(0, V, (2, 7)).astype(np.int32)
    dec = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T,
                decode=True)
    want = np.asarray(jgeneration.generate(dec, flax_params,
                                           jnp.asarray(prompt), 12))
    got = generation.generate(_port_model(flax_params),
                              torch.from_numpy(prompt), 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_heads_above_256_engine_tokens_match_reference(flax_params):
    """Greedy tokens of the paged engines, 2 slots, mixed prompt lengths
    with a prefill past one block: the port (the wide split kernel for
    decode and the wide tiled kernel for tails on the card; the plain
    version here) emits the JAX engine's tokens exactly."""
    rng = np.random.RandomState(10)
    reqs = [(rng.randint(0, V, size=int(n)).tolist(), int(m))
            for n, m in ((5, 6), (23, 5), (40, 4), (9, 7))]
    dec = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T,
                decode=True)
    outs = []
    for engine in (jserving.DecodeEngine(dec, flax_params, slots=2),
                   serving.DecodeEngine(_port_model(flax_params), slots=2,
                                        device="cpu")):
        with engine as eng:
            outs.append([h.result(300) for h in
                         [eng.submit(p, m) for p, m in reqs]])
    want, got = outs
    assert got == want
    assert all(len(g) == len(p) + m for g, (p, m) in zip(got, reqs))

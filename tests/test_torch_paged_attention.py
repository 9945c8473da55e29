"""The port's paged-attention op against the JAX reference.

The same inputs, made from a seed with numpy, go through the JAX
package's ``paged_attention`` (gather oracle, blockwise ``lax``, and
the Pallas kernel in interpret mode) and through the port's plain
versions (``_blockwise``, ``_gather``) on CPU tensors: outputs agree
within the reference's own fp32 tolerance (2e-6), and within a looser
one for int8 pools. The port's blockwise version must also never read
a dead pool row (NaN poison), and its int8 quantizer must match JAX's
bitwise. The CUDA kernel itself is held against these plain versions
on the card by ``chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
# the kernels' TF32 rounding of an operand's hi part, and what an mma
# reads of a float32 register (the flash kernels' emulation)
from test_torch_flash_attention import _tf32, _tf32_read

from tensorflowonspark_tpu_torch.ops import paged_attention as tpa

jpa = importlib.import_module("tensorflowonspark_tpu.ops.paged_attention")

#: fp32: the reference's own tolerance between its formulations
FP32_TOL = 2e-6
#: int8: both sides dequantize the SAME codes and scales, so only the
#: summation order differs — but dequantized values are up to ~3x the
#: float ones' magnitude after the absmax scaling, hence 4x looser
INT8_TOL = 8e-6


def _case(seed, b=3, s_q=1, n=4, d=16, pool=11, bs=8, mb=4):
    """Random pools + per-row tables (distinct allocated rows, no
    scratch aliasing) and positions at each row's own depth."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s_q, n, d).astype(np.float32)
    kp = rng.randn(pool, bs, n, d).astype(np.float32)
    vp = rng.randn(pool, bs, n, d).astype(np.float32)
    table = np.stack([rng.choice(np.arange(1, pool), size=mb,
                                 replace=False) for _ in range(b)])
    base = rng.randint(0, mb * bs - s_q, size=b)
    pos = base[:, None] + np.arange(s_q)[None, :]
    return q, kp, vp, table.astype(np.int32), pos.astype(np.int32)


def _jax(case, impl, **kw):
    q, kp, vp, table, pos = case[:5]
    scales = {}
    if len(case) == 7:
        scales = {"k_scale": jnp.asarray(case[5]),
                  "v_scale": jnp.asarray(case[6])}
    return np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(pos), impl=impl, **scales, **kw))


def _torch(case, impl=None):
    t = [torch.from_numpy(np.array(a)) for a in case]
    scales = {}
    if len(t) == 7:
        scales = {"k_scale": t[5], "v_scale": t[6]}
    return tpa.paged_attention(*t[:5], impl=impl, **scales).numpy()


def _int8(case):
    """Quantize a float case's pools with the JAX quantizer."""
    q, kp, vp, table, pos = case
    qk, sk = jpa.quantize_kv(jnp.asarray(kp))
    qv, sv = jpa.quantize_kv(jnp.asarray(vp))
    return (q, np.asarray(qk), np.asarray(qv), table, pos,
            np.asarray(sk), np.asarray(sv))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [1, 8])
@pytest.mark.parametrize("port_impl", ["blockwise", "gather"])
def test_port_matches_jax_formulations(port_impl, s_q, quant):
    tol = INT8_TOL if quant else FP32_TOL
    for seed in range(2):
        case = _case(seed, s_q=s_q)
        if quant:
            case = _int8(case)
        got = _torch(case, impl=port_impl)
        for impl, kw in (("gather", {}), ("blockwise", {}),
                         ("pallas", {"interpret": True})):
            np.testing.assert_allclose(got, _jax(case, impl, **kw),
                                       atol=tol, rtol=tol,
                                       err_msg="vs JAX " + impl)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_overshooting_pad_rows_match_jax(quant):
    """Bucket-padded prefill rows whose positions run past the table's
    capacity: the port clamps the row's depth to the table like the
    reference does."""
    case = list(_case(11, s_q=8, mb=3))
    case[4][2] = 20 + np.arange(8)  # positions 20..27 > L - 1 = 23
    case = tuple(case)
    if quant:
        case = _int8(case)
    tol = INT8_TOL if quant else FP32_TOL
    want = _jax(case, "gather")
    np.testing.assert_allclose(_torch(case, "blockwise"), want,
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_torch(case, "gather"), want,
                               atol=tol, rtol=tol)


def test_blockwise_never_reads_dead_blocks():
    """Pool rows outside every row's live block set are NaN-poisoned:
    one read of a dead block would turn outputs NaN (0 * NaN is NaN),
    so the port's blockwise output must stay bitwise unchanged."""
    case = _case(3)
    q, kp, vp, table, pos = case
    bs = kp.shape[1]
    clean = _torch(case, "blockwise")
    live = set()
    for bi in range(q.shape[0]):
        nblk = (int(pos[bi].max()) + bs) // bs
        live |= set(int(x) for x in table[bi, :nblk])
    dead = [r for r in range(kp.shape[0]) if r not in live]
    assert dead, "case must leave dead rows"
    kpo, vpo = kp.copy(), vp.copy()
    kpo[dead] = np.nan
    vpo[dead] = np.nan
    out = _torch((q, kpo, vpo, table, pos), "blockwise")
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, clean)


def test_quantize_kv_matches_jax_bitwise_and_round_trips():
    """Codes and scales equal JAX's bitwise (round-half-even on both
    sides) and the port's numpy mirror in ``paging.BlockPool``'s, zero
    vectors quantize under scale 1.0, and requantizing the dequantized
    grid is a fixed point."""
    from tensorflowonspark_tpu_torch import paging

    rng = np.random.RandomState(0)
    x = rng.randn(5, 8, 4, 16).astype(np.float32)
    x[1, 2, 3] = 0.0
    # exact .5 ties after scaling: absmax 127 makes the scale 1.0
    x[0, 0, 0, :3] = [127.0, 2.5, -3.5]
    qj, sj = jpa.quantize_kv(jnp.asarray(x))
    qt, st = tpa.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    qn, sn = paging.BlockPool.quantize(x)
    np.testing.assert_array_equal(qt.numpy(), qn)
    np.testing.assert_array_equal(st.numpy(), sn)
    assert st[1, 2, 3].item() == 1.0
    assert not qt[1, 2, 3].any()
    q2, s2 = tpa.quantize_kv(tpa.dequantize_kv(qt, st))
    np.testing.assert_array_equal(q2.numpy(), qt.numpy())
    np.testing.assert_array_equal(s2.numpy(), st.numpy())


def test_dispatcher_cpu_takes_plain_version_and_validates():
    """On CPU tensors the dispatcher runs the plain version and never
    launches the kernel; forcing the kernel on a CPU tensor raises; a
    bad ``impl`` or a lone scale is refused."""
    case = _case(5, s_q=8)
    before = tpa.launches
    np.testing.assert_array_equal(_torch(case), _torch(case, "blockwise"))
    assert tpa.launches == before
    t = [torch.from_numpy(a) for a in case]
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(*t, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        tpa.paged_attention(*t, impl="pallas")
    with pytest.raises(ValueError, match="together"):
        tpa.paged_attention(*t, k_scale=torch.ones(11, 8, 4))
    assert tpa.launches == before


# -- the split-KV route's schedule and merge, emulated ------------------


def _split_case(seed, quant):
    """Four decode rows (one query each) at the edges the split route
    meets: position mid-block (row 0), past the table (row 1), an
    inactive all-scratch row at position 0 (row 2), one short of the
    table's end (row 3)."""
    b, n, d, bs, mb = 4, 2, 16, 8, 6
    rng = np.random.RandomState(seed)
    pool = b * mb + 1
    q = rng.randn(b, 1, n, d).astype(np.float32)
    kp = rng.randn(pool, bs, n, d).astype(np.float32)
    vp = rng.randn(pool, bs, n, d).astype(np.float32)
    table = (rng.permutation(pool - 1)[:b * mb] + 1).reshape(b, mb)
    pos = np.array([[20], [mb * bs], [0], [mb * bs - 2]])
    table[2] = 0                                    # all scratch
    case = (q, kp, vp, table.astype(np.int32), pos.astype(np.int32))
    return _int8(case) if quant else case


def _split_partials(q, kp, vp, table, pos, scale, c, k_scale=None,
                    v_scale=None):
    """Per row, the (m [S_q, N], l [S_q, N], acc [S_q, N, D]) that the
    split kernel writes for each of its C-block splits over the row's
    live blocks (splits past them are never launched)."""
    b, s_q, n, d = q.shape
    bs = kp.shape[1]
    nblk = tpa._nblocks(pos, bs, table.shape[1])
    out = []
    for r in range(b):
        parts = []
        for j0 in range(0, max(0, int(nblk[r])), c):
            blocks = table[r, j0:min(j0 + c, int(nblk[r]))].long()
            k, v = kp[blocks], vp[blocks]
            if k_scale is not None:
                k = tpa.dequantize_kv(k, k_scale[blocks])
                v = tpa.dequantize_kv(v, v_scale[blocks])
            k, v = k.reshape(-1, n, d).float(), v.reshape(-1, n, d).float()
            kpos = torch.arange(j0 * bs, j0 * bs + k.shape[0])
            s = torch.einsum("qnd,knd->qnk", q[r], k) * scale
            vis = (kpos[None, :] <= pos[r][:, None])[:, None, :]
            s = torch.where(vis, s, torch.full_like(s, float("-inf")))
            m = s.amax(-1)
            safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
            p = torch.where(torch.isneginf(s), torch.zeros_like(s),
                            torch.exp(s - safe[..., None]))
            parts.append((m, p.sum(-1), torch.einsum("qnk,knd->qnd", p, v)))
        out.append(parts)
    return out


def _merge_in_order(parts, shape):
    """The combine kernel: per row, M = max m_s, then sum e^(m_s - M) l_s
    and e^(m_s - M) acc_s in split order; no visible key gives 0."""
    out = torch.zeros(shape)
    for r, row in enumerate(parts):
        if not row:
            continue
        big = torch.stack([m for m, _, _ in row]).amax(0)
        safe = torch.where(torch.isneginf(big), torch.zeros_like(big), big)
        l_sum = torch.zeros_like(big)
        acc = torch.zeros(shape[1:])
        for m, l, a in row:
            w = torch.where(torch.isneginf(m), torch.zeros_like(m),
                            torch.exp(m - safe))
            l_sum = l_sum + w * l
            acc = acc + w[..., None] * a
        out[r] = acc / torch.where(l_sum == 0, torch.ones_like(l_sum),
                                   l_sum)[..., None]
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_split_kv_schedule_matches_gather_and_jax(c, quant):
    """Partial softmax states over C-block splits of each decode row's
    live blocks (S_q = 1, the route's one shape), merged in split order,
    equal the port's gather oracle and the JAX package's reference on the
    same seeded inputs: depth mid-block, past the table, an all-scratch
    row; C = 8 puts a row's live blocks in one split. Every split the
    kernel launches holds a visible key (its first key sits at or below
    the query's position), so the merge never meets an empty one."""
    case = _split_case(20 + c, quant)
    t = [torch.from_numpy(np.array(a)) for a in case]
    scales = t[5:] if quant else [None, None]
    scale = t[0].shape[-1] ** -0.5
    parts = _split_partials(*t[:5], scale, c, *scales)
    got = _merge_in_order(parts, tuple(t[0].shape)).numpy()
    tol = INT8_TOL if quant else FP32_TOL
    np.testing.assert_allclose(got, _torch(case, "gather"), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got, _jax(case, "gather"), atol=tol,
                               rtol=tol)
    for row in parts:
        for m, l, _ in row:
            assert torch.isfinite(m).all() and (l > 0).all()
    # the all-scratch row reads its one live block (pool row 0) only
    assert len(parts[2]) == 1


def test_route_picks_split_kv_for_decode():
    """Decode (S_q = 1) takes the split-KV route at the head dims it is
    built for; any wider window, prefill tails and other head dims up to
    128 the tensor-core tiled one; head dims above 128 (to 256) the
    CUDA-core tiled one, whatever the window. On CPU tensors no route
    launches."""
    assert tpa.SPLIT_MAX_QUERIES == 1
    assert tpa.TILED_MAX_HEAD_DIM == 128
    assert tpa._route(1, 64) == "split"
    assert tpa._route(1, 128) == "split"
    assert tpa._route(2, 64) == "tiled"
    assert tpa._route(1, 48) == "tiled"
    assert tpa._route(256, 64) == "tiled"
    assert tpa._route(300, 128) == "tiled"
    assert tpa._route(16, 129) == "tiled_simt"
    assert tpa._route(1, 192) == "tiled_simt"
    assert tpa._route(40, 256) == "tiled_simt"
    assert set(tpa.route_launches) == {"split", "tiled", "tiled_simt"}
    before = dict(tpa.route_launches)
    _torch(_case(2, s_q=1))
    _torch(_case(2, s_q=8, d=192))
    assert tpa.route_launches == before


# -- the tensor-core tiled route's schedule and arithmetic, emulated ----

#: the card's limit for a paged kernel against ``_blockwise``
#: (chip_smoke.py KERNEL_TOL, tests/test_torch_cuda_kernel.py TOL)
KERNEL_TOL = 1e-5


def _mm(a, b, passes, b_exact=False):
    """``a @ b`` as ``mma3_rows`` computes it: ``passes`` 3 sums lo.hi,
    hi.lo, then hi.hi in float32 (``b_exact``: b is exact in TF32, as int8
    codes are, and its hi.lo pass is dropped: 2 passes); 1 is one TF32
    pass."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if passes > 1:
        out = out + _tf32_read(a - ah) @ bh
        if not b_exact:
            out = out + ah @ _tf32_read(b - bh)
    return out + ah @ bh


def _emulated_tiled(q, kp, vp, table, pos, scale, passes=3, k_scale=None,
                    v_scale=None, bn=64, warps=4, rows=16):
    """The tiled kernel's schedule on CPU tensors: per (row, 16-query
    tile) the key limit min(nblk bs, the tile's highest position + 1);
    keys addressed one by one through the table (key j: pool row
    table[b, j // bs], token j % bs), so a key tile crosses pool blocks;
    D zero-padded to the kernel's instantiation; the ``bn``-key tiles
    taken from tile ``x mod tiles`` on, wrapping around (``x`` the query
    tile's CTA, deepest first), split between ``warps`` warps, each with
    its own online softmax per tile; S = Q K^T and P V through ``_mm``
    (int8: codes are exact, the scales fold into S's and P's columns);
    the warps merged in order."""
    quant = k_scale is not None
    b, s_q, n, d = q.shape
    bs = kp.shape[1]
    dp = next(x for x in (16, 32, 64, 128) if x >= d)
    kw = bn // warps
    nblk = tpa._nblocks(pos, bs, table.shape[1])
    out = torch.zeros(b, s_q, n, d)
    for r in range(b):
        for i0 in range(0, s_q, rows):
            pr = torch.full((rows,), torch.iinfo(torch.int32).min)
            live = pos[r, i0:i0 + rows]
            pr[:len(live)] = live
            n_keys = max(0, min(int(nblk[r]) * bs, int(live.max()) + 1))
            key = torch.arange(n_keys)
            blk = table[r, key // bs].long()
            tok = key % bs
            k, v = kp[blk, tok].float(), vp[blk, tok].float()  # [K, n, d]
            pad = (0, dp - d)
            k = torch.nn.functional.pad(k, pad).permute(1, 0, 2)
            v = torch.nn.functional.pad(v, pad).permute(1, 0, 2)
            qt = torch.zeros(rows, n, dp)
            qt[:len(live), :, :d] = q[r, i0:i0 + rows]
            qt = qt.permute(1, 0, 2)                         # [n, 16, dp]
            m = torch.full((warps, n, rows), float("-inf"))
            l = torch.zeros(warps, n, rows)
            acc = torch.zeros(warps, n, rows, dp)
            n_kv = -(-n_keys // bn)
            cta = -(-s_q // rows) - 1 - i0 // rows
            for it in range(n_kv):
                j0 = (it + cta % n_kv) % n_kv * bn
                for w in range(warps):
                    sel = torch.arange(min(j0 + w * kw, n_keys),
                                       min(j0 + (w + 1) * kw, n_keys))
                    if len(sel) == 0:
                        continue
                    s = _mm(qt, k[:, sel].transpose(-1, -2), passes,
                            b_exact=quant)
                    if quant:
                        s = s * k_scale[blk[sel], tok[sel]].T[:, None, :]
                    s = s * scale
                    vis = sel[None, :] <= pr[:, None]        # [16, kw]
                    s = torch.where(vis[None], s, float("-inf"))
                    m_new = torch.maximum(m[w], s.amax(-1))
                    safe = torch.where(torch.isneginf(m_new),
                                       torch.zeros_like(m_new), m_new)
                    corr = torch.where(torch.isneginf(m[w]),
                                       torch.zeros_like(m_new),
                                       torch.exp(m[w] - safe))
                    p = torch.where(torch.isneginf(s), torch.zeros_like(s),
                                    torch.exp(s - safe[..., None]))
                    l[w] = l[w] * corr + p.sum(-1)
                    if quant:
                        p = p * v_scale[blk[sel], tok[sel]].T[:, None, :]
                    acc[w] = acc[w] * corr[..., None] + _mm(
                        p, v[:, sel], passes, b_exact=quant)
                    m[w] = m_new
            big = m.amax(0)
            safe = torch.where(torch.isneginf(big), torch.zeros_like(big),
                               big)
            cw = torch.where(torch.isneginf(m), torch.zeros_like(m),
                             torch.exp(m - safe))
            L = (cw * l).sum(0)
            A = (cw[..., None] * acc).sum(0)
            o = A / torch.where(L == 0, torch.ones_like(L), L)[..., None]
            out[r, i0:i0 + rows] = o.permute(1, 0, 2)[:len(live), :, :d]
    return out


def _tiled_case(seed, bs, quant, d=48, s_q=40):
    """Three rows of ``s_q`` queries crossing three 16-query tiles: row 0
    deep in the table at positions with gaps, out of order and repeated;
    row 1 an overshooting pad row (positions past the table); row 2 an
    inactive all-scratch row at positions 0..s_q-1. Depths span two to
    three 64-key tiles, so key tiles cross pool blocks at any block
    size."""
    b, n = 3, 2
    mb = -(-150 // bs)
    rng = np.random.RandomState(seed)
    pool = b * mb + 1
    q = rng.randn(b, s_q, n, d).astype(np.float32)
    kp = rng.randn(pool, bs, n, d).astype(np.float32)
    vp = rng.randn(pool, bs, n, d).astype(np.float32)
    table = (rng.permutation(pool - 1)[:b * mb] + 1).reshape(b, mb)
    pos = np.zeros((b, s_q), np.int64)
    pos[0] = rng.choice(np.arange(40, mb * bs - 5), size=s_q, replace=False)
    pos[0, :3] = pos[0, 3]
    pos[1] = mb * bs - s_q // 2 + np.arange(s_q)
    pos[2] = np.arange(s_q)
    table[2] = 0
    case = (q, kp, vp, table.astype(np.int32), pos.astype(np.int32))
    return _int8(case) if quant else case


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bs", [8, 12, 16, 32])
def test_tiled_schedule_matches_gather_and_jax(bs, quant):
    """The tiled kernel's schedule and tensor-core arithmetic on CPU:
    key tiles that cross pool blocks (block sizes 8, 16, 32 and 12, which
    does not divide a 64-key tile), per-query positions that are not
    consecutive, an overshooting pad row and an all-scratch row, D 48
    padded to 64. 3xTF32 (float pools) and 2 passes on the exact int8
    codes with the scales folded into S's and P's columns hold the
    card's 1e-5 limit against the port's gather oracle and the JAX
    package's reference; one TF32 pass misses it, which is why the
    kernel pays for more."""
    case = _tiled_case(100 + bs, bs, quant)
    t = [torch.from_numpy(np.array(a)) for a in case]
    scales = t[5:] if quant else [None, None]
    scale = t[0].shape[-1] ** -0.5
    want_port = _torch(case, "gather")
    want_jax = _jax(case, "gather")
    got = _emulated_tiled(*t[:5], scale, 3 if not quant else 2,
                          *scales).numpy()
    for want in (want_port, want_jax):
        assert np.abs(got - want).max() <= KERNEL_TOL
    one = _emulated_tiled(*t[:5], scale, 1, *scales).numpy()
    assert np.abs(one - want_port).max() > KERNEL_TOL


def test_tiled_schedule_int8_codes_need_two_passes_exactly():
    """int8 codes are exact in TF32 (|code| <= 127): the hi.lo pass on
    the codes adds exactly 0, so the kernel's 2 passes give the bits of
    all 3."""
    case = _tiled_case(7, 16, True)
    t = [torch.from_numpy(np.array(a)) for a in case]
    codes = t[1].float()
    assert torch.equal(_tf32(codes), codes)
    scale = t[0].shape[-1] ** -0.5
    q = t[0][0, :16, 0]
    k = codes[1, :, 0]
    assert torch.equal(_mm(q, k.T, 2, b_exact=True), _mm(q, k.T, 3))
    a = _emulated_tiled(*t[:5], scale, 2, *t[5:])
    assert torch.isfinite(a).all()

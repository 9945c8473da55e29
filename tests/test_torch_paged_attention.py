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


@pytest.mark.parametrize("d", [192, 256])
def test_block_64_at_wide_heads_refuses_only_for_the_device(d):
    """A D-192 or D-256 engine with a pool block of 64: the tensor-core
    tiled route finds each key row through the table and takes any block
    size at any head dim, as the reference's ``_pallas`` does, so the
    wrapper passes every shape check and stops only at its device check
    on CPU tensors. (The CUDA-core route it replaced above 128 scored one
    key per lane and refused blocks above 32.)"""
    case = _case(6, s_q=8, d=d, bs=64, mb=2)
    t = [torch.from_numpy(a) for a in case]
    assert tpa._route(8, d) == (
        "window" if d == 256 and tpa.WINDOW_MAX_QUERIES >= 8 else "tiled")
    with pytest.raises(ValueError, match="every tensor must be CUDA"):
        tpa._kernel(*t, scale=d ** -0.5)


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


# -- the window route's schedule and merge, emulated --------------------


def _window_case(seed, s_q, d, quant, consecutive, c):
    """Six rows of ``s_q`` queries (2 heads of ``d``, block 8, a table of
    10 blocks) at the edges the window route meets: the last query on a
    block's last key (row 0), mid-block (row 1), on the first key of a
    split of ``c`` blocks (row 2), past the table (row 3), an all-scratch
    row at positions 0..s_q-1 (row 4), and one whose queries sit far
    apart, the first at key 2, so it sees no key of the row's later
    splits (row 5).
    ``consecutive=False`` also spreads, repeats and reorders every deep
    row's positions."""
    b, n, bs, mb = 6, 2, 8, 10
    rng = np.random.RandomState(seed)
    pool = b * mb + 1
    q = rng.randn(b, s_q, n, d).astype(np.float32)
    kp = rng.randn(pool, bs, n, d).astype(np.float32)
    vp = rng.randn(pool, bs, n, d).astype(np.float32)
    table = (rng.permutation(pool - 1)[:b * mb] + 1).reshape(b, mb)
    last = np.array([5 * bs - 1, 6 * bs + 3, c * bs, mb * bs + 2, s_q - 1,
                     9 * bs + 1])
    pos = last[:, None] - s_q + 1 + np.arange(s_q)[None, :]
    pos[5] = np.linspace(2, last[5], s_q).astype(int)
    if not consecutive:
        for r in (0, 1, 2):
            pos[r] = rng.choice(np.arange(1, last[r] + 1), size=s_q,
                                replace=False)
            pos[r, 0] = pos[r, -1]                 # a repeated position
            pos[r, -1] = last[r]                   # the same depth
            rng.shuffle(pos[r])
    table[4] = 0                                   # all scratch
    case = (q, kp, vp, table.astype(np.int32), pos.astype(np.int32))
    return _int8(case) if quant else case


def _window_partials(q, kp, vp, table, pos, scale, c, k_scale=None,
                     v_scale=None, warps=4):
    """The window kernel's schedule on CPU tensors: per row, one split per
    C pool blocks of the live blocks its HIGHEST position reaches (a
    split past them is never launched); in a split, warp w takes blocks
    j_lo + w, j_lo + w + ``warps``, ..; every query keeps its own mask
    (key <= its position) and state, so a query that sees no key of a
    warp or a split carries m = -inf, l = 0 there; int8 scales fold into
    the dot and into p, as the kernel applies them; the warps merge in
    order 0..3. Per row, the splits' (m [S_q, N], l [S_q, N], acc [S_q,
    N, D])."""
    b, s_q, n, d = q.shape
    bs = kp.shape[1]
    nblk = tpa._nblocks(pos, bs, table.shape[1])
    neg = float("-inf")
    out = []
    for r in range(b):
        parts = []
        for j0 in range(0, int(nblk[r]), c):
            state = None
            for w in range(warps):
                js = list(range(j0 + w, min(j0 + c, int(nblk[r])), warps))
                m = torch.full((s_q, n), neg)
                l = torch.zeros(s_q, n)
                acc = torch.zeros(s_q, n, d)
                if js:
                    blocks = table[r, js].long()
                    k = kp[blocks].reshape(-1, n, d).float()
                    v = vp[blocks].reshape(-1, n, d).float()
                    s = torch.einsum("qnd,knd->qnk", q[r], k)
                    if k_scale is not None:
                        s = s * k_scale[blocks].reshape(-1, n).T[None]
                    s = s * scale
                    kpos = torch.cat([torch.arange(j * bs, (j + 1) * bs)
                                      for j in js])
                    vis = (kpos[None, :] <= pos[r][:, None])[:, None, :]
                    s = torch.where(vis, s, torch.full_like(s, neg))
                    m = s.amax(-1)
                    safe = torch.where(torch.isneginf(m),
                                       torch.zeros_like(m), m)
                    p = torch.where(torch.isneginf(s), torch.zeros_like(s),
                                    torch.exp(s - safe[..., None]))
                    l = p.sum(-1)
                    if v_scale is not None:
                        p = p * v_scale[blocks].reshape(-1, n).T[None]
                    acc = torch.einsum("qnk,knd->qnd", p, v)
                if state is None:
                    state = (m, l, acc)
                    continue
                m0, l0, a0 = state
                mn = torch.maximum(m0, m)
                safe = torch.where(torch.isneginf(mn), torch.zeros_like(mn),
                                   mn)
                c0 = torch.where(torch.isneginf(m0), torch.zeros_like(m0),
                                 torch.exp(m0 - safe))
                c1 = torch.where(torch.isneginf(m), torch.zeros_like(m),
                                 torch.exp(m - safe))
                state = (mn, l0 * c0 + l * c1,
                         a0 * c0[..., None] + acc * c1[..., None])
            parts.append(state)
        out.append(parts)
    return out


@pytest.mark.parametrize("consecutive", [True, False],
                         ids=["consecutive", "spread"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("s_q", [2, 4, 8])
def test_window_schedule_matches_gather_and_jax(s_q, d, quant, consecutive):
    """The window route's schedule on CPU: each row's splits of C =
    ``WINDOW_BLOCKS`` pool blocks up to its highest position, per-query
    masks and online
    softmax state (queries whose positions are consecutive, or spread,
    repeated and out of order), the warps' blocks merged in warp order
    and the splits in split order, an all-scratch row, an overshooting
    one, depths on and off block and split boundaries, and a query that
    sees no key of some split (m = -inf, l = 0 there, skipped by the
    merge). Equals the port's gather oracle and the JAX package's
    reference on the same seeded inputs within the stated tolerance."""
    c = tpa.WINDOW_BLOCKS
    case = _window_case(1000 + 10 * s_q + d + quant, s_q, d, quant,
                        consecutive, c)
    t = [torch.from_numpy(np.array(a)) for a in case]
    scales = t[5:] if quant else [None, None]
    scale = d ** -0.5
    parts = _window_partials(*t[:5], scale, c, *scales)
    got = _merge_in_order(parts, tuple(t[0].shape)).numpy()
    tol = INT8_TOL if quant else FP32_TOL
    np.testing.assert_allclose(got, _torch(case, "gather"), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got, _jax(case, "gather"), atol=tol,
                               rtol=tol)
    # row 5's first query sees key 2 only: no key of its later splits
    m, l, _ = parts[5][-1]
    assert len(parts[5]) == -(-10 // c) > 1
    assert torch.isneginf(m[0]).all() and (l[0] == 0).all()
    assert torch.isfinite(m[-1]).all() and (l[-1] > 0).all()
    # every launched split holds a key some query of its row sees
    for row in parts:
        for m, l, _ in row:
            assert torch.isfinite(m).any(dim=0).all()
    # the all-scratch row reads its one live block (pool row 0) only
    assert len(parts[4]) == 1


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_d256_decode_merge_at_the_d256_decoders_depths(quant):
    """Split-KV decode at D 256 as its own kernel runs it, at the D-256
    decoder's serving depths (``chip_smoke.py`` 17(b)'s seeded 8 slots
    of 32..640 tokens, block 16, a table of 64 blocks; 2 heads): C =
    ``SPLIT_BLOCKS`` pool blocks a split, ceil(live blocks / C) splits a
    row, each warp's blocks merged in warp order, then the row's splits
    merged in split order by whichever CTA publishes the last one.
    Equals the port's gather oracle and the JAX package's reference on
    the same seeded inputs."""
    b, n, d, bs, mb = 8, 2, 256, 16, 64
    depths = np.random.RandomState(1234 + 1).randint(32, 641, size=b)
    rng = np.random.RandomState(17)
    pool = b * mb + 1
    q = rng.randn(b, 1, n, d).astype(np.float32)
    kp = rng.randn(pool, bs, n, d).astype(np.float32)
    vp = rng.randn(pool, bs, n, d).astype(np.float32)
    table = (rng.permutation(pool - 1)[:b * mb] + 1).reshape(b, mb)
    pos = (depths - 1)[:, None].astype(np.int32)
    for r in range(b):
        table[r, (int(pos[r, 0]) + bs) // bs:] = 0
    case = (q, kp, vp, table.astype(np.int32), pos)
    if quant:
        case = _int8(case)
    t = [torch.from_numpy(np.array(a)) for a in case]
    scales = t[5:] if quant else [None, None]
    c = tpa.SPLIT_BLOCKS
    parts = _window_partials(*t[:5], d ** -0.5, c, *scales)
    for r in range(b):
        live = (int(pos[r, 0]) + bs) // bs
        assert len(parts[r]) == -(-live // c)
    got = _merge_in_order(parts, tuple(t[0].shape)).numpy()
    tol = INT8_TOL if quant else FP32_TOL
    np.testing.assert_allclose(got, _torch(case, "gather"), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got, _jax(case, "gather"), atol=tol,
                               rtol=tol)


def test_route_picks_split_kv_for_decode():
    """Decode (S_q = 1) takes the split-KV route at the head dims it is
    built for, and 2 to ``WINDOW_MAX_QUERIES`` queries a row (the verify
    window, short prefill tails) the window route there; wider windows,
    prefill tails and every other head dim up to 256 the tensor-core
    tiled one. On CPU tensors no route launches."""
    assert tpa.SPLIT_MAX_QUERIES == 1
    assert tpa.TILED_MAX_HEAD_DIM == 256
    w = tpa.WINDOW_MAX_QUERIES
    assert w >= 4                      # chip_smoke.py's SPEC_K
    assert tpa._route(1, 64) == "split"
    assert tpa._route(1, 128) == "split"
    assert tpa._route(1, 256) == "split"
    assert tpa._route(2, 64) == "window"
    assert tpa._route(w, 256) == "window"
    assert tpa._route(w + 1, 64) == "tiled"
    assert tpa._route(2, 48) == "tiled"
    assert tpa._route(1, 48) == "tiled"
    assert tpa._route(256, 64) == "tiled"
    assert tpa._route(300, 128) == "tiled"
    assert tpa._route(16, 129) == "tiled"
    assert tpa._route(1, 192) == "tiled"
    assert tpa._route(40, 256) == "tiled"
    assert set(tpa.route_launches) == {"split", "window", "tiled"}
    before = dict(tpa.route_launches)
    _torch(_case(2, s_q=1))
    _torch(_case(2, s_q=8, d=192))
    assert tpa.route_launches == before


@pytest.mark.parametrize("s_q", [2, 16, 40, 512])
def test_tiled_route_takes_every_wide_head_dim(s_q):
    """Above 128 every head dim to 256 but 256 itself takes the
    tensor-core tiled route once a row has more than one query (prefill
    tails, cold prompts, the speculative verify window), and decode at a
    width the split kernel is not built for does too; D 256 takes the
    window route up to ``WINDOW_MAX_QUERIES`` queries and the tiled one
    above; nothing above 256 has a kernel."""
    window = s_q <= tpa.WINDOW_MAX_QUERIES
    for d in range(129, 257):
        assert tpa._route(s_q, d) == (
            "window" if window and d == 256 else "tiled"), d
        assert tpa._route(1, d) == ("split" if d == 256 else "tiled"), d
    assert {tpa._route(s_q, d) for d in range(1, 257)} == (
        {"window", "tiled"} if window else {"tiled"})


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_tiled_smem_at_d256_fits_the_card(quant):
    """The DP-256 tile's shared memory, reckoned here from its parts
    (``tc_smem`` in ``csrc/paged_attention.cu``): the 16-row float32 Q
    tile, then a ring of two stages of 32 K and 32 V rows (float32 rows
    of 1 KB; int8 rows of 256 codes and 16 pad bytes, with a float32
    scale a row) whose space the 4 warps' (m, l, acc[256]) merge reuses.
    Q plus the larger of the two fits the card's 227 KB; the merge fits
    the space after Q; it is more than the 48 KB a launch gets without
    the attribute, which the launch raises."""
    q_tile = 16 * 256 * 4
    ring = 2 * 2 * 32 * ((256 + 16) if quant else 256 * 4)
    if quant:
        ring += 2 * 2 * 32 * 4
    merge = 4 * 16 * (256 + 2) * 4
    total = q_tile + max(ring, merge)
    assert total == tpa.tiled_smem_bytes(256, quant)
    assert tpa.tiled_smem_bytes(192, quant) == total   # padded to 256
    assert total <= tpa.MAX_SMEM_BYTES == 232448
    assert merge <= total - q_tile
    assert total > 48 * 1024
    assert total == (147456 if not quant else 82432)


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


def _mm_parts(a, b, passes, b_exact, parts):
    """``_mm`` with the contraction's 8-wide steps dealt into ``parts``
    partial sums (step ``ks`` into sum ``ks % parts``), added in order:
    how the tiled kernel takes S = Q K^T at DP 256."""
    if parts == 1:
        return _mm(a, b, passes, b_exact)
    steps = a.shape[-1] // 8
    out = None
    for u in range(parts):
        cols = torch.cat([torch.arange(8 * ks, 8 * ks + 8)
                          for ks in range(u, steps, parts)])
        part = _mm(a[..., cols], b[..., cols, :], passes, b_exact)
        out = part if out is None else out + part
    return out


def _emulated_tiled(q, kp, vp, table, pos, scale, passes=3, k_scale=None,
                    v_scale=None, bn=64, warps=4, rows=16, parts=1):
    """The tiled kernel's schedule on CPU tensors: per (row, 16-query
    tile) the key limit min(nblk bs, the tile's highest position + 1);
    keys addressed one by one through the table (key j: pool row
    table[b, j // bs], token j % bs), so a key tile crosses pool blocks;
    D zero-padded to the kernel's instantiation; the ``bn``-key tiles
    taken from tile ``x mod tiles`` on, wrapping around (``x`` the query
    tile's CTA, deepest first), split between ``warps`` warps, each with
    its own online softmax per tile; S = Q K^T (over ``parts`` partial
    sums, ``_mm_parts``) and P V through ``_mm`` (int8: codes are exact,
    the scales fold into S's and P's columns); the warps merged in
    order."""
    quant = k_scale is not None
    b, s_q, n, d = q.shape
    bs = kp.shape[1]
    dp = next(x for x in (16, 32, 64, 128, 256) if x >= d)
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
                    s = _mm_parts(qt, k[:, sel].transpose(-1, -2), passes,
                                  quant, parts)
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
@pytest.mark.parametrize("bs", [8, 12, 16, 32, 64, 128])
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


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("d", [192, 256])
def test_tiled_d256_schedule_matches_gather_and_jax(d, bs, quant):
    """The DP-256 instantiation's schedule and arithmetic on CPU: 32-key
    tiles (8 keys a warp), S = Q K^T's 32 k steps dealt into 4 partial
    sums, D 192 zero-padded to 256, block 64 beside 16 (the block the
    CUDA-core route refused); the cases of the D <= 128 schedule test
    (positions with gaps and repeats, an overshooting pad row, an
    all-scratch row). 3xTF32 (2 passes on int8 codes) holds the card's
    1e-5 limit against the port's gather oracle and the JAX package's
    reference."""
    case = _tiled_case(200 + d + bs, bs, quant, d=d)
    t = [torch.from_numpy(np.array(a)) for a in case]
    scales = t[5:] if quant else [None, None]
    scale = d ** -0.5
    got = _emulated_tiled(*t[:5], scale, 2 if quant else 3, *scales,
                          bn=32, parts=4).numpy()
    for want in (_torch(case, "gather"), _jax(case, "gather")):
        assert np.abs(got - want).max() <= KERNEL_TOL

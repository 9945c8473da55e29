"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``cuda`` marker; skips where torch sees no CUDA device):
paged attention on its three routes (split-KV; query-tiled on the tensor
cores at block sizes 8-32, windows 2-300 and head dims 16-128; the
CUDA-core tiled kernel above 128), with depths on and off split
boundaries, positions that are not consecutive, its determinism,
NaN-poisoned dead pool rows and the tiled kernel's register budget; and
the three flash-attention kernels (forward, dQ, dK/dV), with
the two-stage copy ring run through many tiles and a ragged last one,
32-row tiles at D 128, the backward's determinism (no atomics) and the
register budgets at D 64. ``chip_smoke.py`` runs the
same comparisons at the main paths' widths; these are the small-shape
versions for ``pytest -m cuda``."""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.ops import paged_attention as pa

#: same fp32 online softmax on both sides; only summation order differs
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(dev, rng, s_q, quant, depths, b=3, n=4, d=16, bs=8, mb=6,
                scratch_row=None):
    """Pools, a table of distinct pool rows per row (scratch 0 past each
    row's live blocks) and positions ending at each row's depth."""
    pool = b * mb + 1
    q = torch.from_numpy(rng.randn(b, s_q, n, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(pool, bs, n, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(pool, bs, n, d).astype(np.float32))
    table = torch.from_numpy(
        (rng.permutation(pool - 1)[:b * mb] + 1).reshape(b, mb)
        .astype(np.int32))
    if scratch_row is not None:
        table[scratch_row] = 0  # an inactive slot: all scratch
    depth = torch.tensor(depths)[:, None]
    pos = (depth - s_q + torch.arange(s_q)[None, :]).to(torch.int32)
    for r in range(b):
        live = min((int(pos[r].max()) + bs) // bs, mb)
        table[r, live:] = 0
    scales = {}
    if quant:
        kp, ks = pa.quantize_kv(kp)
        vp, vs = pa.quantize_kv(vp)
        scales = {"k_scale": ks.to(dev), "v_scale": vs.to(dev)}
    return [t.to(dev) for t in (q, kp, vp, table, pos)], scales


def _launch(args, scales):
    """One kernel call; returns the output and the route it took."""
    before = dict(pa.route_launches)
    got = pa.paged_attention(*args, **scales)
    torch.cuda.synchronize()
    moved = [r for r in before if pa.route_launches[r] != before[r]]
    assert len(moved) == 1 and pa.route_launches[moved[0]] == \
        before[moved[0]] + 1
    return got, moved[0]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [1, 2, 4, 8, 16, 40])
def test_kernel_matches_blockwise(cuda, s_q, quant):
    """Both routes: split-KV for decode (S_q = 1), query-tiled for every
    wider window; rows at depth mid-table, overshooting the table, and
    all scratch."""
    rng = np.random.RandomState(s_q)
    mb, bs = 6, 8
    args, scales = _paged_case(cuda, rng, s_q, quant,
                               [mb * bs - 3, mb * bs + 5, s_q], mb=mb, bs=bs,
                               scratch_row=2)
    before = pa.launches
    got, route = _launch(args, scales)
    assert pa.launches == before + 1
    assert route == ("split" if s_q <= pa.SPLIT_MAX_QUERIES else "tiled")
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_split_route_depths_on_and_off_split_boundaries(cuda, d, quant):
    """Rows whose depth ends exactly on a split boundary (C blocks), one
    token past it, one short of it, and mid-block, at every head dim the
    split kernel is built for; block 16 and a table wider than the
    deepest row, so some splits hold no live block."""
    rng = np.random.RandomState(d)
    bs, mb = 16, 20
    span = pa.SPLIT_BLOCKS * bs
    depths = [span, span + 1, 2 * span - 1, 2 * span + bs // 2, 1]
    args, scales = _paged_case(cuda, rng, 1, quant, depths, b=len(depths),
                               n=2, d=d, bs=bs, mb=mb)
    got, route = _launch(args, scales)
    assert route == "split"
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("s_q", [1, 16, 300],
                         ids=["split", "tiled", "tiled-300"])
def test_paged_kernel_is_deterministic(cuda, s_q):
    """The split route merges its partial states in split order, the
    tiled route its warps' states in warp order (no atomics): two calls
    on the same inputs are bitwise equal."""
    rng = np.random.RandomState(7)
    args, scales = _paged_case(cuda, rng, s_q, False, [390, 347, 320],
                               bs=16, mb=26)
    first, _ = _launch(args, scales)
    second, _ = _launch(args, scales)
    assert torch.equal(first, second)


def _poison_dead(dev, args, scales, bs):
    """The case with every pool row outside all rows' live blocks
    NaN-poisoned (int8: their scales, as codes cannot hold NaN)."""
    table, pos = args[3].cpu(), args[4].cpu()
    live = set()
    for r in range(table.shape[0]):
        nblk = min((int(pos[r].max()) + bs) // bs, table.shape[1])
        live |= set(int(x) for x in table[r, :nblk])
    dead = torch.tensor(sorted(set(range(args[1].shape[0])) - live),
                        device=dev, dtype=torch.long)
    assert dead.numel() > 0
    args = list(args)
    if scales:
        scales = {k: v.clone() for k, v in scales.items()}
        for v in scales.values():
            v[dead] = float("nan")
    else:
        args[1], args[2] = args[1].clone(), args[2].clone()
        args[1][dead] = float("nan")
        args[2][dead] = float("nan")
    return args, scales


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_split_route_never_reads_dead_rows(cuda, quant):
    """Pool rows outside every row's live blocks are NaN-poisoned (int8:
    their scales): one read would turn an output NaN, so the split
    route's output must stay bitwise unchanged."""
    rng = np.random.RandomState(11)
    bs, mb = 8, 6
    args, scales = _paged_case(cuda, rng, 1, quant, [13, mb * bs + 5, 1],
                               bs=bs, mb=mb, scratch_row=2)
    clean, route = _launch(args, scales)
    assert route == "split"
    poisoned, _ = _launch(*_poison_dead(cuda, args, scales, bs))
    assert torch.equal(poisoned, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [16, 40])
def test_tiled_route_never_reads_dead_rows(cuda, s_q, quant):
    """The tensor-core tiled route under the same poison, at a block size
    (12) that does not divide its key tiles, with rows mid-table,
    overshooting the table and all scratch: its copies stop at each
    tile's key limit, so the output stays bitwise unchanged."""
    rng = np.random.RandomState(12 + s_q)
    bs, mb = 12, 8
    args, scales = _paged_case(cuda, rng, s_q, quant,
                               [5 * bs + 3, mb * bs + 5, s_q], bs=bs, mb=mb,
                               scratch_row=2)
    clean, route = _launch(args, scales)
    assert route == "tiled"
    poisoned, _ = _launch(*_poison_dead(cuda, args, scales, bs))
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [2, 16, 40, 300])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_tiled_route_block_sizes_and_windows(cuda, bs, s_q, quant):
    """Key tiles that cross pool blocks at block sizes 8, 16 and 32, and
    windows from 2 queries to 300 (19 query tiles of 16, the last one
    ragged), against ``_blockwise``: rows deep in the table, overshooting
    it and all scratch."""
    rng = np.random.RandomState(1000 * bs + s_q)
    mb = -(-(s_q + 40) // bs)
    args, scales = _paged_case(cuda, rng, s_q, quant,
                               [mb * bs - 3, mb * bs + 5, s_q], n=2, d=64,
                               bs=bs, mb=mb, scratch_row=2)
    got, route = _launch(args, scales)
    assert route == "tiled"
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [16, 18, 20, 48, 64, 128, 192])
def test_tiled_routes_head_dims(cuda, d, quant):
    """The tensor-core tiled kernel at its instantiations (16, 64, 128)
    and at 18, 20 and 48, zero-padded in shared memory: rows of 72 float
    bytes take 4-byte copies, int8 rows of 20 codes 4-byte and of 18
    codes byte copies; above 128 the CUDA-core tiled kernel (192)."""
    rng = np.random.RandomState(d)
    bs, mb, s_q = 16, 6, 40
    args, scales = _paged_case(cuda, rng, s_q, quant, [mb * bs - 7, 50, s_q],
                               n=2, d=d, bs=bs, mb=mb)
    got, route = _launch(args, scales)
    assert route == ("tiled" if d <= pa.TILED_MAX_HEAD_DIM else "tiled_simt")
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_tiled_route_positions_not_consecutive(cuda, quant):
    """Per-query positions with gaps, out of order and repeated within a
    query tile (as a verify window or a packed batch may send them):
    each query sees the keys up to its own position."""
    rng = np.random.RandomState(5)
    bs, mb, s_q = 16, 8, 40
    args, scales = _paged_case(cuda, rng, s_q, quant, [mb * bs - 1, 90, 60],
                               n=2, bs=bs, mb=mb)
    pos = np.stack([rng.choice(depth, size=s_q, replace=False)
                    for depth in (mb * bs, 90, 60)])
    pos[1, :4] = pos[1, 4]                      # repeated positions
    args[4] = torch.from_numpy(pos.astype(np.int32)).to(cuda)
    got, route = _launch(args, scales)
    assert route == "tiled"
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_tiled_budget_at_d64(cuda, quant):
    """At the serving head dim the tensor-core tiled kernel keeps its
    scores, softmax state and accumulators in registers (no spills) and
    fits at least two CTAs per SM."""
    got = pa.budget(64, quant)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 2
    assert 0 < got["smem_bytes"] <= 227 * 1024


#: flash kernels against their plain versions on the same inputs. lse
#: (float32 in every dtype) and float32 outputs: max |kernel - plain| <=
#: 1e-4 max(1, max |plain|): the forward differs in summation order only,
#: the backward's 3xTF32 tensor-core products are float32-accurate.
#: bfloat16 outputs, element by element, as each side rounds a float32
#: result once (at most one ulp, 2^-7 relative, apart): gradients within
#: 2^-7 |plain| + 1e-3 max |plain| (the floor for order noise where a sum
#: cancels); out within 2^-7 (|plain| + sum_j p_j |v_j|), as both sides
#: also round each P entry to bfloat16 at different scales (2^-8 relative
#: apart at most, a factor 2 under that)
FLASH_F32_RTOL = 1e-4
BF16_RTOL, BF16_FLOOR = 2.0 ** -7, 1e-3

#: (b, s_q, s_k, n, d, causal, masked, dtype)
FLASH_CASES = [
    (2, 80, 80, 2, 16, True, False, torch.float32),      # ragged tiles
    (2, 64, 160, 3, 32, False, True, torch.float32),     # rect + full row
    (2, 128, 128, 2, 64, True, True, torch.bfloat16),
    (1, 72, 72, 1, 128, True, False, torch.float32),
    # the backward's cp.async ring through 9 tiles, the last one ragged
    (1, 520, 520, 2, 64, True, False, torch.bfloat16),
    # D 128: 32-row streamed tiles; rectangular, key mask, ragged S_k
    (2, 256, 200, 2, 128, False, True, torch.float32),
]
FLASH_IDS = ["causal-ragged", "rect-mask", "bf16", "d128",
             "bf16-many-tiles", "d128-rect-mask"]


def _assert_close(got, want, pv=None):
    """``pv``: ``sum_j p_j |v_j|`` where ``got`` is a bfloat16 out."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert fin.any()
    g, w = got.float()[fin], want.float()[fin]
    top = w.abs().max().item()
    if got.dtype == torch.bfloat16 and pv is not None:
        limit = BF16_RTOL * (w.abs() + pv.float()[fin])
    elif got.dtype == torch.bfloat16:
        limit = BF16_RTOL * w.abs() + BF16_FLOOR * top
    else:
        limit = FLASH_F32_RTOL * max(1.0, top)
    assert ((g - w).abs() <= limit).all()


def _flash_inputs(dev, case):
    b, s_q, s_k, n, d, causal, masked, dtype = case
    rng = np.random.RandomState(s_q + d)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype).contiguous()

    q, k, v = t(b, s_q, n, d), t(b, s_k, n, d), t(b, s_k, n, d)
    dout = t(b, s_q, n, d)
    g_lse = torch.from_numpy(rng.randn(b * n, s_q).astype(np.float32)).to(
        dev)
    bias = None
    if masked:
        m = torch.from_numpy(rng.rand(b, s_k) > 0.3)
        m[:, 0] = True
        m[-1] = False  # the last batch row attends to nothing
        bias = fa._mask_to_bias(m.to(dev))
    return q, k, v, dout, g_lse, bias


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_kernels_match_plain(cuda, case):
    b, s_q, s_k, n, d, causal, masked, dtype = case
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = d ** -0.5
    before = dict(fa.launches)
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout, g_lse)
    dq = fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale)
    dk, dv = fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert fa.launches == {k_: before[k_] + 1 for k_ in before}
    want_out, want_lse = fa._reference_lse(q, k, v, causal, scale, bias)
    want_dq = fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    want_dk, want_dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta,
                                     causal, scale)
    pv, _ = fa._reference_lse(q, k, v.abs(), causal, scale, bias)
    _assert_close(lse, want_lse.reshape(b * n, s_q))
    for got, want, row in ((out, want_out, pv), (dq, want_dq, None),
                           (dk, want_dk, None), (dv, want_dv, None)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        _assert_close(got, want, row)
    if masked:
        assert (out[-1] == 0).all() and (dq[-1] == 0).all()


@pytest.mark.cuda
def test_flash_backward_is_deterministic(cuda):
    """dQ and dK/dV have one writer per output tile and no atomics: two
    launches on the same inputs are bitwise equal."""
    case = (2, 200, 200, 3, 64, True, False, torch.float32)
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = 64 ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, True, scale)
    delta = fa._delta(out, dout, g_lse)
    first = (fa._kernel_dq(q, k, v, bias, dout, lse, delta, True, scale),
             *fa._kernel_dkv(q, k, v, bias, dout, lse, delta, True, scale))
    second = (fa._kernel_dq(q, k, v, bias, dout, lse, delta, True, scale),
              *fa._kernel_dkv(q, k, v, bias, dout, lse, delta, True, scale))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_flash_backward_budget_at_d64(cuda, kind, dtype):
    """At the training head dim the backward kernels keep every value in
    registers (no local-memory spills) and fit at least one CTA per SM
    within the card's shared memory."""
    got = fa.budget(kind, 64, dtype)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["smem_bytes"] <= 227 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_forward_budget_at_d64(cuda, dtype):
    """The forward on the tensor cores keeps its scores, online softmax
    and accumulators in registers at the training head dim: no spills,
    and at least two CTAs per SM."""
    got = fa.budget("fwd", 64, dtype)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 2
    assert 0 < got["smem_bytes"] <= 227 * 1024

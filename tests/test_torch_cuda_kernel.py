"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``cuda`` marker; skips where torch sees no CUDA device):
paged attention on its three routes (split-KV; query-tiled on the tensor
cores at block sizes 8-128, windows 2-300 and head dims 16-128; the
CUDA-core tiled kernel above 128, which alone keeps the 32-token block
limit), with depths on and off split
boundaries, positions that are not consecutive, its determinism,
NaN-poisoned dead pool rows and the tiled kernel's register budget; and
the three flash-attention kernels (forward, dQ, dK/dV), with
the two-stage copy ring run through many tiles and a ragged last one,
32-row tiles at D 128, the backward's determinism (no atomics) and the
register budgets at D 64; the bfloat16 forward, dQ and dK/dV
(``wgmma`` + TMA) at every head dim, ragged and rectangular, with a key
mask, at BERT-base's attention shape, dQ with whole key tiles masked in
the middle and at the end of a row, and bitwise deterministic; and ring
attention's kernel route (a 4-way ring in lockstep) against its plain
route in every schedule and both dtypes; the speculative verify window
(S_q = k from mid-sequence cursors), a speculative engine's exact
route counts, two fleet replicas launching from their own threads with
exact counts, and ``DecodeEngine.measure_attn``'s exact launches.
``chip_smoke.py`` runs the same comparisons at the main paths' widths; these are the small-shape
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


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_verify_window_matches_blockwise(cuda, k, quant):
    """The speculative verify window: S_q = k queries a row from
    mid-sequence cursors (8 slots at mixed depths, one a block boundary
    away, one inactive), the tiled route, bitwise on a repeat and blind
    to NaN-poisoned dead pool rows."""
    rng = np.random.RandomState(100 + k)
    bs, mb = 16, 12
    depths = [k, bs, bs + 1, 2 * bs - k + 1, 57, 100, mb * bs - 1, k]
    args, scales = _paged_case(cuda, rng, k, quant, depths, b=8, n=4,
                               d=64, bs=bs, mb=mb, scratch_row=7)
    got, route = _launch(args, scales)
    assert route == "tiled"
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    again, _ = _launch(args, scales)
    assert torch.equal(again, got)
    pargs, pscales = _poison_dead(cuda, args, scales, bs)
    poisoned, _ = _launch(pargs, pscales)
    assert torch.equal(poisoned, got)


@pytest.mark.cuda
def test_speculative_engine_routes_and_tokens(cuda):
    """A speculative engine on the card: each round launches the
    draft's k one-token steps on the split route and the target's
    k-query verify on the tiled route — exactly, by the round count —
    and its tokens equal a plain engine's except where the top-2 logits
    tie (the two take different routes)."""
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    torch.manual_seed(0)
    model = DecoderLM(128, hidden=64, num_heads=4, num_layers=2,
                      max_len=128, device=cuda)
    model.init_weights(torch.Generator(device=cuda).manual_seed(1))
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 128, size=rng.randint(3, 40)).tolist(),
             int(rng.randint(4, 30))) for _ in range(6)]
    with serving.DecodeEngine(model, slots=4, kv_block_size=16,
                              device=cuda) as eng:
        want = [h.result(300) for h in [eng.submit(p, n) for p, n in reqs]]
    for route in pa.route_launches:
        pa.route_launches[route] = 0
    with serving.DecodeEngine(model, slots=4, kv_block_size=16,
                              speculate_k=3, device=cuda) as eng:
        got = [h.result(300) for h in [eng.submit(p, n) for p, n in reqs]]
        counts = eng.counters.snapshot()["counts"]
    rounds, prefills = counts["decode_steps"], counts["prefills"]
    assert pa.route_launches == {"split": 1 * 3 * rounds,
                                 "tiled": 2 * rounds + (2 + 1) * prefills,
                                 "tiled_simt": 0}
    for (prompt, _), g, w in zip(reqs, got, want):
        if g == w:
            continue
        first = next(j for j in range(len(g)) if g[j] != w[j])
        assert first >= len(prompt)
        with torch.no_grad():
            logits = model(torch.tensor([g[:first]], device=cuda))[0, -1]
        top = torch.topk(logits, 2).values
        assert (top[0] - top[1]).item() < 1e-4


@pytest.mark.cuda
def test_two_fleet_replicas_share_the_card_with_exact_launches(cuda):
    """Two in-process fleet replicas on one card, fed through the
    router by concurrent clients: their schedulers launch the paged
    kernel from two threads, taking turns on the card's one launch
    lock, and the launch counts stay exact — split =
    layers x the replicas' decode steps, tiled = layers x their
    prefills — and the tokens equal one engine's but where the top-2
    logits tie."""
    import http.client
    import json
    import threading

    from tensorflowonspark_tpu_torch import fleet, serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    model = DecoderLM(128, hidden=64, num_heads=4, num_layers=2,
                      max_len=128, device=cuda)
    model.init_weights(torch.Generator(device=cuda).manual_seed(2))
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, 128, size=rng.randint(3, 60)).tolist(),
             int(rng.randint(4, 40))) for _ in range(8)]
    with serving.DecodeEngine(model, slots=4, kv_block_size=16,
                              device=cuda) as eng:
        want = [h.result(300) for h in [eng.submit(p, n) for p, n in reqs]]
    for route in pa.route_launches:
        pa.route_launches[route] = 0
    got = [None] * len(reqs)
    with fleet.ServingFleet(model, replicas=2, name="lm",
                            engine_kw={"slots": 4, "kv_block_size": 16,
                                       "device": cuda},
                            beat_interval=0.05) as f:
        host, port = f.router_addr

        def client(c):
            conn = http.client.HTTPConnection(host, port, timeout=300)
            for i in range(c, len(reqs), 4):
                conn.request("POST", "/v1/models/lm:generate", json.dumps(
                    {"prompt": reqs[i][0], "max_new_tokens": reqs[i][1]}))
                got[i] = json.loads(conn.getresponse().read())["tokens"]

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        counts = [r.engine.counters.snapshot()["counts"]
                  for r in f.replicas]
        assert all(r.engine.device.type == "cuda" for r in f.replicas)
        # the two engines take turns launching on the one card
        turns = {id(r.engine._turn) for r in f.replicas}
        assert len(turns) == 1 and id(eng._turn) in turns
    assert all(c.get("requests_completed", 0) > 0 for c in counts)
    steps = sum(c["decode_steps"] for c in counts)
    prefills = sum(c["prefills"] for c in counts)
    assert pa.route_launches == {"split": 2 * steps, "tiled": 2 * prefills,
                                 "tiled_simt": 0}
    for (prompt, _), g, w in zip(reqs, got, want):
        if g == w:
            continue
        first = next(j for j in range(len(g)) if g[j] != w[j])
        assert first >= len(prompt)
        with torch.no_grad():
            logits = model(torch.tensor([g[:first]], device=cuda))[0, -1]
        top = torch.topk(logits, 2).values
        assert (top[0] - top[1]).item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_measure_attn_launches_the_paged_kernel(cuda, kv_dtype):
    """``DecodeEngine.measure_attn(reps)`` times the hand-written paged
    kernel on the split route at the live pool's shapes: the route
    counts rise by exactly ``reps + 1`` (one unmeasured warm call), and
    nothing on the other routes. The same probe under
    ``attn_impl="gather"`` launches nothing."""
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    model = DecoderLM(128, hidden=64, num_heads=4, num_layers=2,
                      max_len=128, device=cuda)
    model.init_weights(torch.Generator(device=cuda).manual_seed(1))
    with serving.DecodeEngine(model, slots=4, kv_block_size=16,
                              kv_dtype=kv_dtype, device=cuda) as eng:
        before = dict(pa.route_launches)
        ms = eng.measure_attn(reps=5)
        assert ms > 0 and eng.timers.counts()["attn"] == 5
        assert {r: pa.route_launches[r] - before[r] for r in before} == \
            {"split": 6, "tiled": 0, "tiled_simt": 0}
        if kv_dtype:
            assert eng.measure_dequant(reps=2) > 0
        assert eng.kv_cache_bytes() == sum(
            t.numel() * t.element_size() for layer in eng._cache
            for t in layer.values())
    with serving.DecodeEngine(model, slots=4, kv_block_size=16,
                              attn_impl="gather", device=cuda) as eng:
        before = dict(pa.route_launches)
        assert eng.measure_attn(reps=2) > 0
        assert pa.route_launches == before


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
@pytest.mark.parametrize("s_q", [1, 40], ids=["split", "tiled"])
@pytest.mark.parametrize("bs", [64, 128])
def test_routes_take_block_sizes_above_32(cuda, bs, s_q, quant):
    """Block sizes past the CUDA-core route's 32 on the split and the
    tensor-core tiled routes (``DecodeEngine(kv_block_size=64)``'s
    pools): within TOL of ``_blockwise`` for a row mid-table, one
    overshooting the table and an all-scratch one, and NaN-poisoned
    dead pool rows leave the output bitwise unchanged."""
    rng = np.random.RandomState(bs + s_q)
    mb = 5
    args, scales = _paged_case(cuda, rng, s_q, quant,
                               [2 * bs + 7, mb * bs + 5, s_q], n=2, d=64,
                               bs=bs, mb=mb, scratch_row=2)
    got, route = _launch(args, scales)
    assert route == ("split" if s_q == 1 else "tiled")
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    poisoned, _ = _launch(*_poison_dead(cuda, args, scales, bs))
    assert torch.equal(poisoned, got)


@pytest.mark.cuda
def test_simt_route_refuses_block_64(cuda):
    """The CUDA-core route (head dims above 128) scores one key per
    lane, so it alone keeps the 32-token block limit."""
    rng = np.random.RandomState(64)
    args, _ = _paged_case(cuda, rng, 16, False, [100, 40, 16], n=1, d=192,
                          bs=64, mb=3)
    before = dict(pa.route_launches)
    with pytest.raises(ValueError, match="tiled_simt"):
        pa.paged_attention(*args)
    assert pa.route_launches == before


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
    # the bfloat16 wgmma forward, dQ and dK/dV at every head dim: 32-,
    # 64- and 128-byte swizzled tiles (D 128 in two column halves), ragged
    # S, rectangular S_q != S_k, a key mask with a fully masked batch row
    (2, 80, 80, 2, 16, False, True, torch.bfloat16),
    (2, 72, 136, 3, 32, False, True, torch.bfloat16),
    (2, 200, 100, 2, 128, False, True, torch.bfloat16),
    (1, 150, 150, 2, 128, True, False, torch.bfloat16),
    # BERT-base's attention at a reduced batch: S 384, 12 heads of 64
    (2, 384, 384, 12, 64, False, True, torch.bfloat16),
]
FLASH_IDS = ["causal-ragged", "rect-mask", "bf16", "d128",
             "bf16-many-tiles", "d128-rect-mask", "bf16-d16-mask",
             "bf16-d32-rect-mask", "bf16-d128-rect-mask",
             "bf16-d128-causal-ragged", "bf16-bert-b2"]


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
@pytest.mark.parametrize("d,causal", [(64, False), (64, True), (128, False),
                                      (128, True)],
                         ids=["d64", "d64-causal", "d128", "d128-causal"])
def test_flash_bf16_dq_skips_dead_key_tiles(cuda, d, causal):
    """The bfloat16 dQ kernel lists a row's live key tiles (64 keys, 32
    at D 128) and walks only those: whole tiles masked in the middle and
    at the end of one batch row, a ragged live tail and a lone live key
    in another, a third row with nothing live (dQ 0). dQ, and the
    forward and dK/dV beside it, agree with the plain versions under the
    unchanged limits."""
    b, s, n = 3, 320, 2
    case = (b, s, s, n, d, causal, False, torch.bfloat16)
    q, k, v, dout, g_lse, _ = _flash_inputs(cuda, case)
    m = torch.from_numpy(np.random.RandomState(d).rand(b, s) > 0.3)
    m[:, 0] = True
    m[0, 64:192] = False           # tiles 1-2 (D 128: 2-5) dead, mid row
    m[0, 256:] = False             # and the last tile
    m[1, 100:] = False             # a ragged live tail
    m[1, 288] = True               # a lone live key in the last tile
    m[2] = False                   # nothing live
    bias = fa._mask_to_bias(m.to(cuda))
    scale = d ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout, g_lse)
    before = fa.launches["dq"]
    dq = fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale)
    dk, dv = fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert fa.launches["dq"] == before + 1
    want_out, want_lse = fa._reference_lse(q, k, v, causal, scale, bias)
    want_dq = fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    want_dk, want_dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta,
                                     causal, scale)
    pv, _ = fa._reference_lse(q, k, v.abs(), causal, scale, bias)
    _assert_close(lse, want_lse.reshape(b * n, s))
    for got, want, row in ((out, want_out, pv), (dq, want_dq, None),
                           (dk, want_dk, None), (dv, want_dv, None)):
        assert torch.isfinite(got).all()
        _assert_close(got, want, row)
    assert (dq[2] == 0).all() and (out[2] == 0).all()
    # a dead key gets no gradient
    assert (dk.float()[~m.to(cuda)] == 0).all()


def _pair_through_route(q, k, v, bias, dout, g_lse, causal, scale):
    """The public autograd pair on the card (the route that pads D and
    slices the batch): out, lse [B*N, S_q], dq, dk, dv."""
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = fa._FlashPair.apply(q, k, v, bias, causal, scale, None)
    torch.autograd.backward([out, lse], [dout, g_lse])
    return out.detach(), lse.detach(), q.grad, k.grad, v.grad


def _check_against_plain(q, k, v, bias, dout, g_lse, causal, scale, got):
    out, lse, dq, dk, dv = got
    b, s_q, n, _ = q.shape
    delta = fa._delta(out, dout, g_lse)
    want_out, want_lse = fa._reference_lse(q, k, v, causal, scale, bias)
    want_dq = fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    want_dk, want_dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta,
                                     causal, scale)
    pv, _ = fa._reference_lse(q, k, v.abs(), causal, scale, bias)
    _assert_close(lse, want_lse.reshape(b * n, s_q))
    for t, want, row in ((out, want_out, pv), (dq, want_dq, None),
                         (dk, want_dk, None), (dv, want_dv, None)):
        assert t.dtype == q.dtype and t.shape == q.shape
        assert torch.isfinite(t).all()
        _assert_close(t, want, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "key_mask"])
@pytest.mark.parametrize("d", [8, 24, 96, 112])
def test_flash_pads_head_dims_it_has_no_instantiation_for(cuda, d, causal,
                                                          masked, dtype):
    """Head dims 8, 24, 96 and 112 run zero-padded to 16, 32, 128 and 128
    with the scale of the true D: out, lse, dQ, dK and dV at the true D
    against the plain versions under the unchanged limits, one launch of
    each kernel."""
    case = (2, 136, 136, 3, d, causal, masked, dtype)
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = d ** -0.5
    before = dict(fa.launches)
    got = _pair_through_route(q, k, v, bias, dout, g_lse, causal, scale)
    torch.cuda.synchronize()
    assert fa.launches == {k_: before[k_] + 1 for k_ in before}
    _check_against_plain(q, k, v, bias, dout, g_lse, causal, scale, got)
    if masked:
        assert (got[0][-1] == 0).all() and (got[2][-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_takes_more_batch_heads_than_one_launch(cuda, dtype):
    """B * N = 65600, above the 65535 one launch takes: the batch goes in
    two slices (4095 rows, then 5), each kernel launched twice, and every
    output agrees with the plain versions."""
    case = (4100, 16, 16, 16, 16, True, True, dtype)
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = 16 ** -0.5
    before = dict(fa.launches)
    got = _pair_through_route(q, k, v, bias, dout, g_lse, True, scale)
    torch.cuda.synchronize()
    assert fa.launches == {k_: before[k_] + 2 for k_ in before}
    _check_against_plain(q, k, v, bias, dout, g_lse, True, scale, got)


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
def test_flash_bf16_dkv_is_deterministic(cuda):
    """The bfloat16 dQ and dK/dV kernels keep one writer per output tile
    (a warpgroup owns 64 queries or keys and loops over the other
    operand's tiles itself; no atomics): two launches on the same inputs
    are bitwise equal, the forward's too."""
    case = (2, 384, 384, 12, 64, False, True, torch.bfloat16)
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = 64 ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, False, scale)
    out2, lse2 = fa._kernel_fwd(q, k, v, bias, False, scale)
    delta = fa._delta(out, dout, g_lse)
    first = (fa._kernel_dq(q, k, v, bias, dout, lse, delta, False, scale),
             *fa._kernel_dkv(q, k, v, bias, dout, lse, delta, False, scale))
    second = (fa._kernel_dq(q, k, v, bias, dout, lse, delta, False, scale),
              *fa._kernel_dkv(q, k, v, bias, dout, lse, delta, False,
                              scale))
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_flash_backward_budget_at_d64(cuda, kind, dtype):
    """At the training head dim the backward kernels keep every value in
    registers (no local-memory spills) and fit at least one CTA per SM
    within the card's shared memory; the bfloat16 dQ kernel (one
    warpgroup, BERT's path) at least two."""
    got = fa.budget(kind, 64, dtype)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    if kind == "dq" and dtype == torch.bfloat16:
        assert got["ctas_per_sm"] >= 2
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


#: (causal, layout, launches of each kernel at P 4, partials a row merges)
RING_CASES = [(True, "contiguous", 10, 4), (True, "zigzag", 36, 8),
              (False, "contiguous", 16, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES,
                         ids=["contiguous-causal", "zigzag", "non-causal"])
def test_ring_kernel_route_matches_plain_ring(cuda, dtype, case):
    """``ring_flash_attention``'s step code as a 4-way lockstep ring (B 2,
    S 512, 2 heads of 64, blocks of 32: local 128, zigzag half 64) on the
    kernel route against the same ring on the plain route, and each
    kernel launched once per live pair (masked pairs launch nothing).
    out within one call's flash limit: the merge is a convex combination
    of partials, so its error is a weighted mean of theirs (bf16: each
    within 2^-7 (|o_i| + pv_i), summing to at most 2^-7 2 pv, plus the
    merged row's rounding on each side, 2^-7 |out|). The q/k/v
    gradients within the flash limits scaled by the partials autograd
    sums (each carries one call's error)."""
    from tensorflowonspark_tpu_torch.parallel import ring_attention as ra

    causal, layout, pairs, partials = case
    rng = np.random.RandomState(12)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, 512, 2, 64).astype(
        np.float32)).to(cuda, dtype) for _ in range(4))

    def run(impl):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        args = (qq, kk, vv)
        if layout == "zigzag":
            args = tuple(ra.to_zigzag(x, 4) for x in args)
        out = ra._ring_lockstep(*args, 4, causal=causal, block_q=32,
                                block_k=32, layout=layout, impl=impl)
        if layout == "zigzag":
            out = ra.from_zigzag(out, 4)
        torch.autograd.backward(out, dout)
        return out.detach(), qq.grad, kk.grad, vv.grad

    before = dict(fa.launches)
    got = run(None)
    torch.cuda.synchronize()
    assert fa.launches == {k_: before[k_] + pairs for k_ in before}
    want = run("plain")
    pv, _ = fa._reference_lse(q, k, v.abs(), causal, 64 ** -0.5)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and torch.isfinite(g).all()
        fin = torch.isfinite(w)
        gf, wf = g.float()[fin], w.float()[fin]
        top = wf.abs().max().item()
        if dtype == torch.bfloat16 and i == 0:
            limit = BF16_RTOL * (wf.abs() + 2 * pv.float()[fin])
        elif dtype == torch.bfloat16:
            limit = BF16_RTOL * wf.abs() + BF16_FLOOR * top
        else:
            limit = FLASH_F32_RTOL * max(1.0, top)
        times = 1 if i == 0 else partials
        assert ((gf - wf).abs() <= times * limit).all(), i

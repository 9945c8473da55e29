"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``cuda`` marker; skips where torch sees no CUDA device):
paged attention on its three routes (split-KV; the window kernel at 2
to ``WINDOW_MAX_QUERIES`` queries a row, head dims 16-256 and block
sizes 8-64; query-tiled on the tensor cores at block sizes 8-128,
windows 2-300 and head dims 16-256, blocks 48 and 64 at 192 and 256),
with depths on and off split boundaries, positions that are not
consecutive, its determinism, NaN-poisoned dead pool rows and the
kernels' register budgets; and
the three flash-attention kernels (forward, dQ, dK/dV), with
the two-stage copy ring run through many tiles and a ragged last one,
32-row tiles at D 128, the float32 forward, dQ and dK/dV at D 256 (one
CTA of 8 warps a row or key tile), the backward's determinism (no atomics) and the register
budgets at D 64 and 256; the bfloat16 forward, dQ and dK/dV
(``wgmma`` + TMA) at every head dim, ragged and rectangular, with a key
mask, at BERT-base's attention shape, dQ with whole key tiles masked in
the middle and at the end of a row, and bitwise deterministic; the
bfloat16 forward, dQ and dK/dV at D 256 (two warpgroups a CTA) over
ragged tiles, wrapping rings, S_q != S_k with a fully masked row, the
forward's 128-row CTA with an empty second warpgroup or one row, D 192
through the padding, bitwise repeats and their budget; and ring
attention's kernel route (a 4-way ring in lockstep) against its plain
route in every schedule and both dtypes; the speculative verify window
(S_q = k from mid-sequence cursors), a speculative engine's exact
route counts, two fleet replicas launching from their own threads with
exact counts, and ``DecodeEngine.measure_attn``'s exact launches; and
both ops at head dims above 256 (``csrc/wide_attention.cu``: 257, 300,
384, 512, 576 and 1024) on every route and in both dtypes, their
budgets, and a D-512 engine's exact launches by route.
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


def _owed_prefills(calls):
    """The paged launches by route that recorded prefills owe: a prefill
    of S_q queries runs one paged call a layer, on the window route
    (2 <= S_q <= ``WINDOW_MAX_QUERIES`` at a split head dim or one above
    256) or the tiled one."""
    owed = {"window": 0, "tiled": 0}
    for s_q, layers, d in calls:
        window = 2 <= s_q <= pa.WINDOW_MAX_QUERIES \
            and (d in pa.SPLIT_HEAD_DIMS or d > 256)
        owed["window" if window else "tiled"] += layers
    return owed


@pytest.fixture
def prefills(monkeypatch):
    """Every paged prefill's (query count, layers, head dim), recorded
    at ``generation.paged_prefill_into_slot``."""
    from tensorflowonspark_tpu_torch import generation

    calls = []
    real = generation.paged_prefill_into_slot

    def record(model, cache, table_row, tokens, *args, **kw):
        calls.append((len(tokens), model.num_layers, model.head_dim))
        return real(model, cache, table_row, tokens, *args, **kw)

    monkeypatch.setattr(generation, "paged_prefill_into_slot", record)
    return calls


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
    """Every route: split-KV for decode (S_q = 1), the window kernel for
    2 to ``WINDOW_MAX_QUERIES`` queries, query-tiled for every wider
    window; rows at depth mid-table, overshooting the table, and all
    scratch."""
    rng = np.random.RandomState(s_q)
    mb, bs = 6, 8
    args, scales = _paged_case(cuda, rng, s_q, quant,
                               [mb * bs - 3, mb * bs + 5, s_q], mb=mb, bs=bs,
                               scratch_row=2)
    before = pa.launches
    got, route = _launch(args, scales)
    assert pa.launches == before + 1
    assert route == ("split" if s_q <= pa.SPLIT_MAX_QUERIES else "window"
                     if s_q <= pa.WINDOW_MAX_QUERIES else "tiled")
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_split_route_depths_on_and_off_split_boundaries(cuda, d, quant):
    """Rows whose depth ends exactly on a split boundary (C blocks), one
    token past it, one short of it, and mid-block, at every head dim the
    split kernel is built for (float32 at 256: two 16-byte vectors a
    lane); block 16 and a table wider than the deepest row, so some
    splits hold no live block."""
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
@pytest.mark.parametrize("s_q", [1, 4, 16, 300],
                         ids=["split", "window", "tiled", "tiled-300"])
def test_paged_kernel_is_deterministic(cuda, s_q):
    """The split and window routes merge their partial states in split
    order, the tiled route its warps' states in warp order (no atomics):
    two calls on the same inputs are bitwise equal."""
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
    away, one inactive), the window route, bitwise on a repeat and blind
    to NaN-poisoned dead pool rows."""
    rng = np.random.RandomState(100 + k)
    bs, mb = 16, 12
    depths = [k, bs, bs + 1, 2 * bs - k + 1, 57, 100, mb * bs - 1, k]
    args, scales = _paged_case(cuda, rng, k, quant, depths, b=8, n=4,
                               d=64, bs=bs, mb=mb, scratch_row=7)
    got, route = _launch(args, scales)
    assert route == "window"
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    again, _ = _launch(args, scales)
    assert torch.equal(again, got)
    pargs, pscales = _poison_dead(cuda, args, scales, bs)
    poisoned, _ = _launch(pargs, pscales)
    assert torch.equal(poisoned, got)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_window_route_matches_blockwise(cuda, d, bs, quant):
    """The window kernel at every query count from 2 to
    ``WINDOW_MAX_QUERIES`` (each instantiation, and the counts between
    them with masked pad queries), every head dim it is built for and
    block sizes 8 to 64: a row deep in the table at positions with
    gaps, out of order and repeated (queries that see no key of the
    row's later splits), one overshooting the table, an all-scratch row
    and a row whose window straddles a split boundary. Within TOL of
    ``_blockwise``, bitwise on a repeat, and blind to NaN-poisoned dead
    pool rows (the deep row's table stays filled past its live
    blocks)."""
    rng = np.random.RandomState(100 * d + bs)
    mb = max(4, -(-300 // bs))
    for s_q in range(2, pa.WINDOW_MAX_QUERIES + 1):
        depths = [mb * bs - 3, mb * bs + 5, s_q,
                  pa.WINDOW_BLOCKS * bs + s_q // 2]
        args, scales = _paged_case(cuda, rng, s_q, quant, depths, b=4, n=2,
                                   d=d, bs=bs, mb=mb, scratch_row=2)
        pos = args[4].cpu().numpy()
        pos[0] = rng.choice(mb * bs - 3, size=s_q, replace=False)
        pos[0, 0] = pos[0, s_q - 1]                # a repeated position
        args[4] = torch.from_numpy(pos).to(cuda)
        got, route = _launch(args, scales)
        assert route == "window"
        want = pa.paged_attention(*args, impl="blockwise", **scales)
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= TOL, (s_q, err)
        again, _ = _launch(args, scales)
        assert torch.equal(again, got), s_q
        poisoned, _ = _launch(*_poison_dead(cuda, args, scales, bs))
        assert torch.equal(poisoned, got), s_q


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bs", [8, 16, 64])
def test_d256_decode_folded_merge(cuda, bs, quant):
    """Split-KV decode at D 256 (its own kernel, the last CTA of each
    (row, head) merging the splits): 8 rows at a D-256 decoder's depths
    and on and off split boundaries, one overshooting the table, one all
    scratch; within TOL of ``_blockwise``, bitwise on repeats (whichever
    CTA merges, the splits merge in split order), blind to NaN-poisoned
    dead pool rows, and every merge ticket back at 0 after the calls."""
    rng = np.random.RandomState(256 + bs)
    mb = -(-700 // bs)
    span = pa.SPLIT_BLOCKS * bs
    depths = [span, span + 1, 2 * span - 1, 227, 640, 33, mb * bs + 5, 1]
    args, scales = _paged_case(cuda, rng, 1, quant, depths, b=8, n=8,
                               d=256, bs=bs, mb=mb, scratch_row=7)
    got, route = _launch(args, scales)
    assert route == "split"
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    for _ in range(3):
        again, _ = _launch(args, scales)
        assert torch.equal(again, got)
    poisoned, _ = _launch(*_poison_dead(cuda, args, scales, bs))
    assert torch.equal(poisoned, got)
    index = torch.cuda.current_device()
    torch.cuda.synchronize()
    assert int(pa._tickets[index][0].abs().sum()) == 0


@pytest.mark.cuda
def test_folded_merges_replay_from_a_cuda_graph(cuda):
    """A window call and a D-256 decode call captured into one CUDA graph
    and replayed: each replay reuses the captured calls' merge tickets,
    which every call leaves at 0, so every replay gives the eager
    outputs bitwise."""
    rng = np.random.RandomState(31)
    win, wsc = _paged_case(cuda, rng, 4, False, [70, 33, 129], n=4, d=64,
                           bs=16, mb=10)
    dec, dsc = _paged_case(cuda, rng, 1, True, [70, 33, 129], n=4, d=256,
                           bs=16, mb=10)
    want = [pa.paged_attention(*win, **wsc), pa.paged_attention(*dec, **dsc)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(*win, **wsc)
        pa.paged_attention(*dec, **dsc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [pa.paged_attention(*win, **wsc),
                pa.paged_attention(*dec, **dsc)]
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("queries", [2, 4])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_window_budget(cuda, d, queries, quant):
    """Every window instantiation (2 and 4 queries) keeps its
    accumulators and online softmax state in registers (no spills) and
    fits the card."""
    got = pa.budget(d, quant, route="window", queries=queries)
    assert got["spill_bytes"] == 0, got
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["smem_bytes"] <= 227 * 1024


@pytest.mark.cuda
def test_speculative_engine_routes_and_tokens(cuda, prefills):
    """A speculative engine on the card: each round launches the
    draft's k one-token steps on the split route and the target's
    k-query verify on the window route — exactly, by the round count —
    each prefill (target and draft) one call a layer on the route its
    query count takes, and its tokens equal a plain engine's except
    where the top-2 logits tie (the two take different routes)."""
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
    del prefills[:]
    with serving.DecodeEngine(model, slots=4, kv_block_size=16,
                              speculate_k=3, device=cuda) as eng:
        got = [h.result(300) for h in [eng.submit(p, n) for p, n in reqs]]
        counts = eng.counters.snapshot()["counts"]
    rounds = counts["decode_steps"]
    # a target's and a draft's prefill for each the engine counts
    assert len(prefills) == 2 * counts["prefills"]
    owed = _owed_prefills(prefills)
    assert pa.route_launches == {"split": 1 * 3 * rounds,
                                 "window": 2 * rounds + owed["window"],
                                 "tiled": owed["tiled"]}
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
def test_two_fleet_replicas_share_the_card_with_exact_launches(cuda,
                                                               prefills):
    """Two in-process fleet replicas on one card, fed through the
    router by concurrent clients: their schedulers launch the paged
    kernel from two threads, taking turns on the card's one launch
    lock, and the launch counts stay exact — split =
    layers x the replicas' decode steps, window and tiled = layers x
    their prefills by query count — and the tokens equal one engine's
    but where the top-2 logits tie."""
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
    del prefills[:]
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
    assert len(prefills) == sum(c["prefills"] for c in counts)
    assert pa.route_launches == dict(split=2 * steps,
                                     **_owed_prefills(prefills))
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
            {"split": 6, "window": 0, "tiled": 0}
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
    ragged; 2 queries take the window route), against ``_blockwise``:
    rows deep in the table, overshooting it and all scratch."""
    rng = np.random.RandomState(1000 * bs + s_q)
    mb = -(-(s_q + 40) // bs)
    args, scales = _paged_case(cuda, rng, s_q, quant,
                               [mb * bs - 3, mb * bs + 5, s_q], n=2, d=64,
                               bs=bs, mb=mb, scratch_row=2)
    got, route = _launch(args, scales)
    assert route == ("window" if s_q <= pa.WINDOW_MAX_QUERIES else "tiled")
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [1, 40], ids=["split", "tiled"])
@pytest.mark.parametrize("bs", [64, 128])
def test_routes_take_block_sizes_above_32(cuda, bs, s_q, quant):
    """Block sizes above 32 on the split and the tensor-core tiled routes
    (``DecodeEngine(kv_block_size=64)``'s pools): within TOL of ``_blockwise`` for a row mid-table, one
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
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("bs", [48, 64])
def test_wide_heads_take_block_sizes_above_32(cuda, bs, d, quant):
    """A D-192 or D-256 engine with a pool block of 48 or 64 (the
    CUDA-core route these widths took before refused blocks above 32):
    the tensor-core tiled route within TOL of ``_blockwise`` for a row
    mid-table, one overshooting the table and an all-scratch one, and
    NaN-poisoned dead pool rows leave the output bitwise unchanged."""
    rng = np.random.RandomState(bs + d)
    mb = 4
    args, scales = _paged_case(cuda, rng, 16, quant,
                               [2 * bs + 7, mb * bs + 5, 16], n=2, d=d,
                               bs=bs, mb=mb, scratch_row=2)
    got, route = _launch(args, scales)
    assert route == "tiled"
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    poisoned, _ = _launch(*_poison_dead(cuda, args, scales, bs))
    assert torch.equal(poisoned, got)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize(
    "d,bs", [(16, 16), (18, 16), (20, 16), (48, 16), (64, 16), (128, 16),
             (192, 16), (256, 16), (256, 32), (256, 48), (256, 64),
             (130, 16)],
    ids=["16", "18", "20", "48", "64", "128", "192", "256", "256-bs32",
         "256-bs48", "256-bs64", "130"])
def test_tiled_routes_head_dims(cuda, d, bs, quant):
    """The tensor-core tiled kernel at its instantiations (16, 64, 128,
    256) and at 18, 20, 48, 130 and 192, zero-padded in shared memory:
    rows of 72 float bytes take 4-byte copies, int8 rows of 20 codes
    4-byte and of 18 codes byte copies; at 256 blocks 16 to 64 (key
    tiles of 32 that cross pool blocks or lie inside one), its shared
    memory above 48 KB granted through the kernel's attribute."""
    rng = np.random.RandomState(d)
    mb, s_q = 96 // bs, 40
    args, scales = _paged_case(cuda, rng, s_q, quant, [mb * bs - 7, 50, s_q],
                               n=2, d=d, bs=bs, mb=mb)
    got, route = _launch(args, scales)
    assert route == "tiled"
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
    # D 256: 8-warp CTAs with column halves (float32), 32-key forward
    # tiles (bfloat16), dK/dV in two halves; causal and ragged,
    # rectangular with a key mask and a fully masked batch row
    (2, 200, 200, 2, 256, True, False, torch.float32),
    (2, 72, 136, 3, 256, False, True, torch.float32),
    (2, 200, 200, 2, 256, True, False, torch.bfloat16),
    (2, 72, 136, 3, 256, False, True, torch.bfloat16),
    # the bfloat16 forward at D 256 runs 128-row CTAs of two warpgroups:
    # S_q <= 64 (the second warpgroup has no rows; rectangular, a key mask
    # and a fully masked batch row), S_q 129 (the last CTA has one row),
    # causal with a key mask and a fully masked batch row
    (2, 48, 136, 2, 256, False, True, torch.bfloat16),
    (2, 129, 129, 2, 256, True, False, torch.bfloat16),
    (2, 136, 136, 2, 256, True, True, torch.bfloat16),
]
FLASH_IDS = ["causal-ragged", "rect-mask", "bf16", "d128",
             "bf16-many-tiles", "d128-rect-mask", "bf16-d16-mask",
             "bf16-d32-rect-mask", "bf16-d128-rect-mask",
             "bf16-d128-causal-ragged", "bf16-bert-b2", "d256-causal-ragged",
             "d256-rect-mask", "bf16-d256-causal-ragged",
             "bf16-d256-rect-mask", "bf16-d256-short-q-mask",
             "bf16-d256-one-row-cta", "bf16-d256-causal-mask"]


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
        assert t.dtype == q.dtype and t.shape == want.shape
        assert torch.isfinite(t).all()
        _assert_close(t, want, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "key_mask"])
@pytest.mark.parametrize("d", [8, 24, 96, 112, 192])
def test_flash_pads_head_dims_it_has_no_instantiation_for(cuda, d, causal,
                                                          masked, dtype):
    """Head dims 8, 24, 96, 112 and 192 run zero-padded to 16, 32, 128,
    128 and 256 with the scale of the true D: out, lse, dQ, dK and dV at
    the true D against the plain versions under the unchanged limits,
    one launch of each kernel."""
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
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "key-mask"])
def test_flash_dkv_d256_one_cta_per_key_tile(cuda, causal, masked):
    """The float32 dK/dV at D 256: one CTA of 8 warps a 64-key tile, a dV
    half (S^T, P^T through shared memory, P^T dO) and a dK half (dP^T,
    dS^T, dS^T Q). Against the plain backward on the same lse and delta,
    causal over a ragged S and rectangular with a key mask that leaves
    one batch row fully masked (its dK and dV 0); two launches bitwise
    equal."""
    case = ((2, 200, 200, 2, 256, True, False, torch.float32) if causal
            else (2, 72, 136, 3, 256, False, True, torch.float32))
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = 256 ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout, g_lse)
    before = fa.launches["dkv"]
    dk, dv = fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal, scale)
    again = fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert fa.launches["dkv"] == before + 2
    want_dk, want_dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta,
                                     causal, scale)
    for got, want, rep_ in ((dk, want_dk, again[0]), (dv, want_dv, again[1])):
        assert torch.isfinite(got).all()
        _assert_close(got, want)
        assert torch.equal(got, rep_)
    if masked:
        assert (dk[-1] == 0).all() and (dv[-1] == 0).all()


#: (b, s_q, s_k, n, d, causal, masked, dtype) for the float32 forward and
#: dQ at D 256
D256_PAIR_CASES = [
    (2, 200, 200, 2, 256, True, False, torch.float32),
    (2, 72, 136, 3, 256, False, True, torch.float32),
    (2, 136, 136, 2, 256, True, True, torch.float32),
    (2, 136, 136, 2, 256, False, False, torch.float32),
]
D256_PAIR_IDS = ["causal-ragged", "rect-mask", "causal-mask", "non-causal"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", D256_PAIR_CASES, ids=D256_PAIR_IDS)
def test_flash_fwd_dq_d256_warp_pairs(cuda, case):
    """The float32 forward and dQ at D 256: one CTA of 8 warps over 64
    query rows, two warps a 16-row block, each owning one 128-column half
    of out or dQ (the forward's pair sums its two halves' partial scores,
    dQ's pair splits S / P and dP between its warps). Against the plain
    versions: causal over a ragged S, rectangular with a key mask that
    leaves one batch row fully masked (out 0, lse -inf, dQ 0), causal
    with that key mask, and non-causal; two launches of each bitwise
    equal."""
    b, s_q, s_k, n, d, causal, masked, dtype = case
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = d ** -0.5
    before = dict(fa.launches)
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout, g_lse)
    dq = fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale)
    out2, lse2 = fa._kernel_fwd(q, k, v, bias, causal, scale)
    dq2 = fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == before["fwd"] + 2
    assert fa.launches["dq"] == before["dq"] + 2
    want_out, want_lse = fa._reference_lse(q, k, v, causal, scale, bias)
    want_dq = fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    _assert_close(lse, want_lse.reshape(b * n, s_q))
    for got, want in ((out, want_out), (dq, want_dq)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        _assert_close(got, want)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(dq, dq2)
    if masked:
        assert (out[-1] == 0).all() and (dq[-1] == 0).all()
        assert torch.isneginf(lse.reshape(b, n, s_q)[-1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "dq"])
def test_flash_d256_warp_pair_budget(cuda, kind):
    """The float32 forward and dQ at D 256 (8 warps, 16 x 128
    accumulators) keep every value in registers under the 255-register
    ceiling (no local-memory spills) and fit at least one CTA an SM in
    the card's 227 KB of shared memory."""
    got = fa.budget(kind, 256, torch.float32)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["registers"] <= 255
    assert 0 < got["smem_bytes"] <= 227 * 1024


#: (b, s_q, s_k, n, d, causal, masked, dtype) for the bfloat16 dQ and
#: dK/dV at D 256 (one CTA of two warpgroups: 64-key K/V tiles in dQ,
#: 32-query Q/dO tiles in dK/dV)
BF16_D256_PAIR_CASES = [
    # S a multiple of neither tile, causal
    (2, 100, 100, 2, 256, True, False, torch.bfloat16),
    # both rings wrap many times (dQ 9 key tiles, dK/dV 17 query tiles),
    # the last tile ragged
    (1, 520, 520, 2, 256, True, False, torch.bfloat16),
    # S_q != S_k both ways with a key mask and a fully masked batch row
    (2, 100, 260, 2, 256, False, True, torch.bfloat16),
    (2, 260, 100, 2, 256, False, True, torch.bfloat16),
    # causal with that key mask; non-causal with none
    (2, 136, 136, 2, 256, True, True, torch.bfloat16),
    (2, 136, 136, 2, 256, False, False, torch.bfloat16),
]
BF16_D256_PAIR_IDS = ["causal-ragged", "ring-wraps", "rect-short-q-mask",
                      "rect-long-q-mask", "causal-mask", "non-causal"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_D256_PAIR_CASES, ids=BF16_D256_PAIR_IDS)
def test_flash_bf16_dq_dkv_d256_warpgroup_pairs(cuda, case):
    """The bfloat16 dQ and dK/dV at D 256, one CTA of two warpgroups: dQ's
    warpgroup 0 forms P and warpgroup 1 dP and dS, handed over through
    shared memory, each adding dS K into one 128-column half; dK/dV's
    warpgroup 0 forms P^T and dV, warpgroup 1 dP^T, dS^T and dK. Against
    the plain versions on the kernel forward's lse and delta: ragged
    tiles, rings that wrap many times, S_q != S_k both ways with a key
    mask leaving one batch row fully masked (its dQ, dK and dV 0), causal
    with a key mask, and non-causal; two launches of each bitwise
    equal."""
    b, s_q, s_k, n, d, causal, masked, dtype = case
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = d ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout, g_lse)
    before = dict(fa.launches)
    dq = fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale)
    dk, dv = fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal, scale)
    dq2 = fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale)
    dk2, dv2 = fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal,
                              scale)
    torch.cuda.synchronize()
    assert fa.launches["dq"] == before["dq"] + 2
    assert fa.launches["dkv"] == before["dkv"] + 2
    want_dq = fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    want_dk, want_dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta,
                                     causal, scale)
    for got, want, again in ((dq, want_dq, dq2), (dk, want_dk, dk2),
                             (dv, want_dv, dv2)):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        _assert_close(got, want)
        assert torch.equal(got, again)
    if masked:
        assert (dq[-1] == 0).all()
        assert (dk[-1] == 0).all() and (dv[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "key_mask"])
def test_flash_bf16_d192_through_the_d256_pairs(cuda, causal, masked):
    """Heads of 192 in bfloat16 run zero-padded to the D-256 kernels
    (dQ and dK/dV as two warpgroups) through the public autograd pair, at
    an S that wraps both backward rings: out, lse, dQ, dK and dV at the
    true D against the plain versions, one launch of each kernel."""
    case = (2, 300, 300, 2, 192, causal, masked, torch.bfloat16)
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = 192 ** -0.5
    before = dict(fa.launches)
    got = _pair_through_route(q, k, v, bias, dout, g_lse, causal, scale)
    torch.cuda.synchronize()
    assert fa.launches == {k_: before[k_] + 1 for k_ in before}
    _check_against_plain(q, k, v, bias, dout, g_lse, causal, scale, got)
    if masked:
        assert (got[0][-1] == 0).all() and (got[2][-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dq", "dkv", "fwd"])
def test_flash_bf16_d256_pair_budget(cuda, kind):
    """The bfloat16 forward, dQ and dK/dV at D 256 (two warpgroups that
    compute, a 64 x 256 float32 accumulator each; the forward's third
    warpgroup only copies, its registers handed to the other two) keep
    every value in registers under the 255-register ceiling (no
    local-memory spills) and fit one CTA an SM in the card's 227 KB of
    shared memory."""
    got = fa.budget(kind, 256, torch.bfloat16)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["registers"] <= 255
    assert 0 < got["smem_bytes"] <= 227 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (2, 384, 384, 12, 64, False, True, torch.bfloat16),
    (2, 300, 300, 2, 256, True, False, torch.bfloat16)],
    ids=["bert", "d256-causal"])
def test_flash_bf16_dkv_is_deterministic(cuda, case):
    """The bfloat16 forward, dQ and dK/dV kernels keep one writer per
    output tile (a warpgroup owns 64 queries or keys and loops over the
    other operand's tiles itself; no atomics): two launches on the same
    inputs are bitwise equal, at BERT's shape and at D 256 (two
    computing warpgroups a CTA, the forward's over one shared K/V ring
    that a third warpgroup fills)."""
    _, _, _, _, d, causal, _, _ = case
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = d ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    out2, lse2 = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout, g_lse)
    first = (fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale),
             *fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal,
                             scale))
    second = (fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale),
              *fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal,
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
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_flash_budget_at_d256(cuda, kind, dtype):
    """Every D-256 instantiation keeps its accumulators in registers (no
    local-memory spills) and fits at least one CTA per SM within the
    card's 227 KB of shared memory."""
    got = fa.budget(kind, 256, dtype)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["smem_bytes"] <= 227 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("route", ["split", "tiled"])
def test_paged_budget_at_d256(cuda, route, quant):
    """The split-KV kernel and the tensor-core tiled kernel at D 256 keep
    their state in registers (the tiled kernel's 16 x 256 accumulator is
    128 registers a lane) and fit the card: the tiled kernel's dynamic
    shared memory, above 48 KB, is what ``tiled_smem_bytes`` reckons and
    is granted through its attribute."""
    got = pa.budget(256, quant, route=route)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["smem_bytes"] <= 227 * 1024
    if route == "tiled":
        assert got["smem_bytes"] == pa.tiled_smem_bytes(256, quant) \
            > 48 * 1024


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


# -- head dims above 256 (csrc/wide_attention.cu) ---------------------------

#: the head dims the wide kernels are held at: 257 (one column past the
#: narrow kernels), 300 (int8 rows of 300 codes break 16-byte alignment),
#: 384, 512 (DeepSeek-V4-Flash), 576 (512 + 64 latent attention, a ragged
#: last 1024-column chunk of the split kernel is not needed, a ragged
#: 128-column one of the tiled kernel is) and 1024
WIDE_DIMS = [257, 300, 384, 512, 576, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [1, 2, 3, 40], ids=["split", "window-2",
                                                   "window-3", "tiled"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_paged_matches_blockwise(cuda, d, s_q, quant):
    """Paged attention above 256 on each route (decode and the verify
    window on the wide split kernel and its combine, a 40-query tail on
    the wide tiled kernel), block 16: rows mid-table, overshooting the
    table and all scratch, within TOL of ``_blockwise``, bitwise on a
    repeat and blind to NaN-poisoned dead pool rows."""
    rng = np.random.RandomState(d + s_q)
    bs, mb = 16, 22
    args, scales = _paged_case(cuda, rng, s_q, quant,
                               [mb * bs - 5, mb * bs + 5, s_q], n=2, d=d,
                               bs=bs, mb=mb, scratch_row=2)
    got, route = _launch(args, scales)
    assert route == pa._route(s_q, d) == (
        "split" if s_q == 1 else "window" if s_q <= 4 else "tiled")
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL
    again, _ = _launch(args, scales)
    assert torch.equal(again, got)
    poisoned, _ = _launch(*_poison_dead(cuda, args, scales, bs))
    assert torch.equal(poisoned, got)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [1, 4, 256], ids=["split", "window",
                                                 "tiled"])
@pytest.mark.parametrize("bs", [1, 64])
def test_wide_paged_block_sizes(cuda, bs, s_q, quant):
    """D 512 at pool blocks of 1 and 64 token rows: every key a block of
    its own, or key tiles inside one block; a 256-query tail deep in the
    table."""
    rng = np.random.RandomState(bs + s_q)
    mb = -(-600 // bs)
    args, scales = _paged_case(cuda, rng, s_q, quant,
                               [mb * bs - 3, 300, s_q], n=2, d=512, bs=bs,
                               mb=mb)
    got, route = _launch(args, scales)
    assert route == pa._route(s_q, 512)
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,masked,s_k",
                         [(True, False, 136), (False, True, 136),
                          (False, True, 200)],
                         ids=["causal", "key_mask", "rect-mask"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_flash_matches_plain(cuda, d, causal, masked, s_k, dtype):
    """The three flash kernels above 256 through the public pair (q, k, v
    and dO zero-padded to a multiple of 128): ragged tiles, causal, a key
    mask with a fully masked batch row, S_q != S_k; out, lse, dQ, dK and
    dV at the true D against the plain versions under the phase-3b
    limits, one launch of each kernel."""
    case = (2, 136, s_k, 3, d, causal, masked, dtype)
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = d ** -0.5
    before = dict(fa.launches)
    got = _pair_through_route(q, k, v, bias, dout, g_lse, causal, scale)
    torch.cuda.synchronize()
    assert fa.launches == {k_: before[k_] + 1 for k_ in before}
    _check_against_plain(q, k, v, bias, dout, g_lse, causal, scale, got)
    if masked:
        assert (got[0][-1] == 0).all() and (got[2][-1] == 0).all()
        assert torch.isneginf(got[1].reshape(2, 3, 136)[-1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_flash_is_deterministic(cuda, dtype):
    """One writer per output tile and column chunk, no atomics: two
    launches of each wide kernel on the same inputs are bitwise equal."""
    case = (2, 200, 200, 2, 512, True, False, dtype)
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = 512 ** -0.5
    first = _pair_through_route(q, k, v, bias, dout, g_lse, True, scale)
    second = _pair_through_route(q, k, v, bias, dout, g_lse, True, scale)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_wide_flash_budget(cuda, kind, dtype):
    """The wide flash kernels keep their 16 x 128 accumulators (two in
    dK/dV) in registers: no spills, at least one CTA an SM, and the same
    instantiation at every D above 256."""
    got = fa.budget(kind, 512, dtype)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["smem_bytes"] <= 227 * 1024
    assert fa.budget(kind, 1024, dtype) == got


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("route,queries", [("split", 1), ("window", 2),
                                           ("window", 4), ("tiled", None)])
def test_wide_paged_budget(cuda, route, queries, quant):
    """The wide paged kernels (split at 1, 2 and 4 queries a row; tiled)
    keep their state in registers and fit the card; the tiled kernel's
    shared memory is what ``tiled_smem_bytes`` reckons above 256."""
    got = pa.budget(512, quant, route=route, queries=queries)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["smem_bytes"] <= 227 * 1024
    if route == "tiled":
        assert got["smem_bytes"] == pa.tiled_smem_bytes(512, quant)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_wide_engine_routes_exact(cuda, prefills, kv_dtype):
    """A D-512 decoder (2 heads of 512, 2 layers) behind ``DecodeEngine``:
    every decode step launches the wide split kernel once a layer and
    every prefill the wide tiled one, exactly; its tokens equal the
    gather engine's but at a top-2 tie."""
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    model = DecoderLM(128, hidden=1024, num_heads=2, num_layers=2,
                      max_len=128, device=cuda)
    model.init_weights(torch.Generator(device=cuda).manual_seed(5))
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(0, 128, size=rng.randint(3, 40)).tolist(),
             int(rng.randint(4, 20))) for _ in range(4)]
    for route in pa.route_launches:
        pa.route_launches[route] = 0
    del prefills[:]
    with serving.DecodeEngine(model, slots=4, kv_block_size=16,
                              kv_dtype=kv_dtype, device=cuda) as eng:
        got = [h.result(300) for h in [eng.submit(p, n) for p, n in reqs]]
        counts = eng.counters.snapshot()["counts"]
    assert len(prefills) == counts["prefills"]
    assert pa.route_launches == {"split": 2 * counts["decode_steps"],
                                 **_owed_prefills(prefills)}
    with serving.DecodeEngine(model, slots=4, kv_block_size=16,
                              kv_dtype=kv_dtype, attn_impl="gather",
                              device=cuda) as eng:
        want = [h.result(300) for h in [eng.submit(p, n) for p, n in reqs]]
    for (prompt, _), g, w in zip(reqs, got, want):
        if g == w:
            continue
        first = next(j for j in range(len(g)) if g[j] != w[j])
        with torch.no_grad():
            logits = model(torch.tensor([g[:first]], device=cuda))[0, -1]
        top = torch.topk(logits, 2).values
        assert (top[0] - top[1]).item() < (1e-3 if kv_dtype else 1e-4)

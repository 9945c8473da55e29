#!/usr/bin/env python3
"""Device time of the paged-attention kernels at the serving paths'
shapes, a breakdown by kernel, the window/tiled crossover, CTA traces,
and an A/B of kernel sources within one run.

    python3 -m tensorflowonspark_tpu_torch.profile_paged \
        [--shape NAME ...] [--variant NAME=DIR ...] [--reps 20] \
        [--crossover] [--trace] [--out DIR] [--split-blocks C,...]

Shapes (``--shape``, repeatable; default ``tail256`` and ``cold512``),
each over as many pool copies as :func:`l2_copies` asks of its live K/V
bytes (at least 4, together 4 times the 50 MB L2), so that the K/V is
not in L2, block 16, a table of 64 blocks:

- ``tail256``, ``cold512``: the serving model's attention widths (12
  heads of 64), one row: a 256-token tail at positions 256..511 (a
  prompt whose first 256 tokens hit the prefix cache) and a cold
  512-token prompt at 0..511 (the tiled route);
- ``tail256_d512``, ``cold512_d512``: the same at the D-512 decoder's
  8 heads of 512 (``csrc/wide_attention.cu``'s tiled kernel; PERF.md row
  1g);
- ``verify``: the speculative verify window as ``chip_smoke.py`` 11(a)
  times it: 8 slots of 4 queries ending at its seeded depths, 12 x 64
  (the window route);
- ``decode``, ``decode256``: a decode step as phase 3 and 17(b) time it:
  8 slots of one query at the seeded depths 32..640, 12 x 64 and 8 x 256
  (the split route).

Float32 and int8 pools. A source's time is its device time per call
through CUDA-graph replays; beside it, ``scaled_dot_product_attention``
on the pre-gathered view, timed the same way (the yardstick
``chip_smoke.py`` uses; the port never calls it), and the package
source's time by kernel (``torch.profiler`` over eager calls: each
kernel's device time per call, and the rest of the graph time — the gap
between a route's two kernels — beside them). ``--variant NAME=DIR``
builds ``DIR/paged_attention.cu`` and ``DIR/wide_attention.cu``, those
of them ``DIR`` holds (with the headers beside them; the package's
source stands in for a missing one), with the package's nvcc flags, all
variants at once (``ops/_build.py`` ``start_variants``), and times them
in turns with the package's own sources — package, variants, variants
reversed, package — each number the mean of its sources' turns, so that
two designs are compared on one card in one call. Each variant's
largest difference from the package sources' output is printed beside
its time (a variant that drops work, to see what that work costs,
differs).

``--crossover`` times the window route against the tiled route at 2, 4,
8 and 16 queries a row (the verify window's depths), at 12 x 64 and 8 x
256, float32 and int8 — on a build of the package source with
``-DTFOS_WINDOW_WIDE``, which also instantiates the window kernel at 8
and 16 queries — and prints the largest query count at which the window
route is the faster at every width and dtype (what
``ops/paged_attention.py`` ``WINDOW_MAX_QUERIES`` is set from).
``--split-blocks 1,2,4,8`` times each shape's package kernels with
each of these pool blocks a CTA (``SPLIT_BLOCKS`` and ``WINDOW_BLOCKS``)
in turns.
``--trace`` builds the package source with ``-DTFOS_PAGED_TRACE`` and,
for each shape, stamps every CTA of one call's first kernel (start and
end on the global timer, its SM): it prints the CTAs launched, the
makespan, CTA durations and CTAs an SM, and with ``--out DIR`` writes
the stamps to ``DIR/paged_trace_<shape>_<dtype>.json``. Needs one card.
"""

import argparse
import json
import os
import re
import sys

import numpy as np

BLOCK, TABLE = 16, 64
SEED = 1234
#: (label, heads, head dim, queries a row, depths of the rows' last
#: query); depths as chip_smoke.py draws them
SHAPES = {
    "tail256": (12, 64, 256, np.array([512])),
    "cold512": (12, 64, 512, np.array([512])),
    "tail256_d512": (8, 512, 256, np.array([512])),
    "cold512_d512": (8, 512, 512, np.array([512])),
    "verify": (12, 64, 4, np.random.RandomState(SEED + 111).randint(
        4 + 32, 641, size=8)),
    "decode": (12, 64, 1, np.random.RandomState(SEED + 1).randint(
        32, 641, size=8)),
    "decode256": (8, 256, 1, np.random.RandomState(SEED + 1).randint(
        32, 641, size=8)),
}
#: the H100's L2 (50 MB); and how many times over a timing's pool
#: copies must exceed it (:func:`l2_copies`)
L2_BYTES = 50 * 2 ** 20
L2_OVER = 4
#: the sources a variant may replace, and that the paged routes launch
SOURCES = ("paged_attention", "wide_attention")
#: the window/tiled crossover's query counts and widths (heads, head dim)
CROSSOVER_QUERIES = (2, 4, 8, 16)
CROSSOVER_WIDTHS = ((12, 64), (8, 256))


def live_kv_bytes(depths, n, d, quant, keys):
    """The K/V bytes one paged call reads: a row ending at depth ``t``
    reads min(t, ``keys``) keys and values of ``n`` heads of ``d``,
    float32 or int8 codes with a float32 scale a (key, head)."""
    live = int(np.minimum(np.asarray(depths), keys).sum())
    return 2 * live * n * (d * (1 if quant else 4) + (4 if quant else 0))


def l2_copies(kv_bytes):
    """Pool copies whose live K/V together exceed the L2 ``L2_OVER``
    times, and at least ``L2_OVER`` of them: a layer's pool is cold when
    the serving step reaches it, so copies that stay inside the L2
    flatter a kernel."""
    return max(L2_OVER, -(-L2_OVER * L2_BYTES // kv_bytes))


def _cases(torch, pa, dev, n, d, s_q, depths, quant, seed):
    """:func:`l2_copies` argument sets ``(q, k_pool, v_pool, table, pos,
    k_scale, v_scale)``: ``len(depths)`` rows of ``s_q`` queries ending at
    ``depths``, each row owning distinct pool rows for its live blocks
    (scratch row 0 past them)."""
    rng = np.random.RandomState(seed)
    b = len(depths)
    pool = b * TABLE + 1
    sets = []
    for _ in range(l2_copies(live_kv_bytes(depths, n, d, quant,
                                           TABLE * BLOCK))):
        shape = (pool, BLOCK, n, d)
        q = rng.randn(b, s_q, n, d).astype(np.float32)
        kp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        vp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        table = (rng.permutation(pool - 1)[:b * TABLE] + 1).reshape(
            b, TABLE).astype(np.int32)
        pos = (depths[:, None] - s_q + np.arange(s_q)[None, :]).astype(
            np.int32)
        for r in range(b):
            table[r, min((int(pos[r].max()) + BLOCK) // BLOCK, TABLE):] = 0
        scales = [None, None]
        if quant:
            kp, ks = pa.quantize_kv(kp)
            vp, vs = pa.quantize_kv(vp)
            scales = [ks.to(dev), vs.to(dev)]
        sets.append([torch.from_numpy(q).to(dev), kp.to(dev), vp.to(dev),
                     torch.from_numpy(table).to(dev),
                     torch.from_numpy(pos).to(dev)] + scales)
    return sets


def sdpa_sets(torch, pa, sets):
    """For each paged argument set ``(q, k_pool, v_pool, table, pos,
    k_scale, v_scale)``, the arguments of one
    ``scaled_dot_product_attention`` call over the same function: q and
    the contiguous K/V view, gathered through the table (and dequantized)
    here, outside any timed call, up to the deepest position, with each
    query's visibility as a boolean mask."""
    out = []
    for q, kp, vp, t, p, ks, vs in sets:
        b, _, n, d = q.shape
        width = min(int(p.max()) + 1, t.shape[1] * kp.shape[1])
        k, v = kp[t.long()], vp[t.long()]
        if ks is not None:
            k = pa.dequantize_kv(k, ks[t.long()])
            v = pa.dequantize_kv(v, vs[t.long()])
        k = k.reshape(b, -1, n, d)[:, :width]
        v = v.reshape(b, -1, n, d)[:, :width]
        mask = (torch.arange(width, device=q.device)[None, None, :]
                <= p[:, :, None].long())[:, None]
        out.append((q.transpose(1, 2).contiguous(),
                    k.transpose(1, 2).contiguous(),
                    v.transpose(1, 2).contiguous(), mask))
    return out


def graph_ms(torch, fn, sets, reps=20):
    """Mean device milliseconds per call: one call per argument set,
    captured once into a CUDA graph and replayed ``reps`` times, so no
    host work sits between the kernels (each call's own allocations are
    replayed from the graph's pool)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in sets:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(sets))


_KERNEL_NAME = re.compile(r"(paged_\w+_kernel<[^>]*>)")


def kernel_ms(torch, fn, sets, reps=20):
    """Device milliseconds per call of each kernel ``fn`` launches
    (``torch.profiler`` over ``reps`` eager passes over ``sets``), by
    kernel name with its template arguments."""
    from torch.profiler import ProfilerActivity, profile

    for a in sets:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for a in sets:
                fn(*a)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = _KERNEL_NAME.search(ev.key)
        if not name:
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        key = name.group(1)
        out[key] = out.get(key, 0.0) + us / 1e3 / (reps * len(sets))
    return out


def trace_summary(stamps):
    """{CTAs, makespan_us, cta_us mean/median/max, SMs, most CTAs on one
    SM} from ``[start ns, end ns, SM]`` rows (rows of zeros: CTAs that
    returned before any work)."""
    rows = np.array([r for r in stamps if r[1] > 0], dtype=np.float64)
    if not len(rows):
        return {"ctas": 0}
    dur = (rows[:, 1] - rows[:, 0]) / 1e3
    per_sm = np.bincount(rows[:, 2].astype(np.int64))
    return {"ctas": int(len(rows)),
            "makespan_us": float((rows[:, 1].max() - rows[:, 0].min())
                                 / 1e3),
            "cta_us_mean": float(dur.mean()),
            "cta_us_median": float(np.median(dur)),
            "cta_us_max": float(dur.max()),
            "last_start_us": float((rows[:, 0].max() - rows[:, 0].min())
                                   / 1e3),
            "sms": int((per_sm > 0).sum()),
            "ctas_per_sm_max": int(per_sm.max())}


def _kernel_fn(pa, scale):
    def kernel(q, kp, vp, t, p, ks, vs):
        return pa.paged_attention(q, kp, vp, t, p, scale=scale,
                                  impl="kernel", k_scale=ks, v_scale=vs)
    return kernel


def crossover(torch, pa, dev, reps, lib):
    """Window against tiled device ms at ``CROSSOVER_QUERIES`` x
    ``CROSSOVER_WIDTHS`` x (float32, int8) on ``lib`` (a build with the
    window kernel at 8 and 16 queries); returns the largest query count
    at which the window route is the faster in every case."""
    from tensorflowonspark_tpu_torch.ops import _build

    depths = SHAPES["verify"][3]
    limit = pa.WINDOW_MAX_QUERIES
    wins = {}
    _build.use({"paged_attention": lib})
    try:
        for n, d in CROSSOVER_WIDTHS:
            for quant in (False, True):
                for s_q in CROSSOVER_QUERIES:
                    sets = _cases(torch, pa, dev, n, d, s_q,
                                  np.maximum(depths, s_q), quant, s_q + d)
                    kernel = _kernel_fn(pa, d ** -0.5)
                    times = {}
                    for route, w in (("window", 16), ("tiled", 1),
                                     ("tiled", 1), ("window", 16)):
                        pa.WINDOW_MAX_QUERIES = w
                        before = dict(pa.route_launches)
                        kernel(*sets[0])
                        assert pa.route_launches[route] == \
                            before[route] + 1, route
                        times.setdefault(route, []).append(
                            graph_ms(torch, kernel, sets, reps))
                    win = float(np.mean(times["window"]))
                    til = float(np.mean(times["tiled"]))
                    wins.setdefault(s_q, []).append(win < til)
                    print("crossover {} x {} {:<7} S_q {:>2}: window {:.4f} "
                          "ms  tiled {:.4f} ms  ({:.2f}x)".format(
                              n, d, "int8" if quant else "float32", s_q,
                              win, til, win / til))
    finally:
        pa.WINDOW_MAX_QUERIES = limit
        _build.use({"paged_attention": _build.load("paged_attention")})
    best = 1
    for s_q in CROSSOVER_QUERIES:
        if not all(wins[s_q]):
            break
        best = s_q
    print("crossover: the window route is the faster through S_q {} at "
          "every width and dtype".format(best))
    return best


def trace(torch, pa, dev, lib, shapes, out_dir):
    """One traced call of each shape and dtype on the trace build
    ``lib``: its first kernel's CTA stamps, summarised and written out."""
    import ctypes

    from tensorflowonspark_tpu_torch.ops import _build

    fn = lib.tfos_paged_trace
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (3 * 16384))()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    _build.use({"paged_attention": lib})
    try:
        for label in shapes:
            n, d, s_q, depths = SHAPES[label]
            for quant in (False, True):
                sets = _cases(torch, pa, dev, n, d, s_q, depths, quant,
                              s_q + quant)
                kernel = _kernel_fn(pa, d ** -0.5)
                for a in sets[1:]:
                    kernel(*a)                   # sets[0] is not in L2
                torch.cuda.synchronize()
                assert fn(buf, 16384) == 0
                kernel(*sets[0])
                torch.cuda.synchronize()
                assert fn(buf, 16384) == 0
                stamps = np.array(buf, dtype=np.uint64).reshape(-1, 3)
                last = np.nonzero(stamps[:, 1])[0]
                stamps = stamps[:last.max() + 1 if len(last) else 0]
                kv = "int8" if quant else "float32"
                summary = trace_summary(stamps.tolist())
                print("trace {} {:<7} {} (route {})".format(
                    label, kv, json.dumps(summary), pa._route(s_q, d)))
                if out_dir:
                    with open(os.path.join(out_dir, "paged_trace_{}_{}.json"
                                           .format(label, kv)), "w") as f:
                        json.dump({"summary": summary,
                                   "stamps": stamps.tolist()}, f)
    finally:
        _build.use({"paged_attention": _build.load("paged_attention")})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", action="append", choices=sorted(SHAPES))
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--split-blocks", default="")
    args = ap.parse_args()
    shapes = args.shape or ["tail256", "cold512"]
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa

    dev = device_info.default_device()
    pending = _build.start_variants(args.variant, SOURCES)
    traced = _build.start_variants(["trace=" + _build.CSRC],
                                   ("paged_attention",),
                                   ("-DTFOS_PAGED_TRACE",)) \
        if args.trace else {}
    wide = _build.start_variants(["wide=" + _build.CSRC],
                                 ("paged_attention",),
                                 ("-DTFOS_WINDOW_WIDE",)) \
        if args.crossover else {}
    libs = {"package": {name: _build.load(name) for name in SOURCES}}
    libs.update(_build.bind_variants(pending, SOURCES))
    order = list(libs) + list(libs)[::-1]
    print(device_info.describe().splitlines()[0])
    for label in shapes:
        n, d, s_q, depths = SHAPES[label]
        scale = d ** -0.5
        kernel = _kernel_fn(pa, scale)
        for quant in (False, True):
            sets = _cases(torch, pa, dev, n, d, s_q, depths, quant,
                          s_q + quant)

            def sdpa(q, k, v, mask):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      scale=scale)

            times = {name: [] for name in libs}
            errs, want = {}, None
            for name in order:
                _build.use(libs[name])
                got = kernel(*sets[0])
                if want is None:
                    want = got
                errs[name] = (got - want).abs().max().item()
                times[name].append(graph_ms(torch, kernel, sets, args.reps))
            _build.use(libs["package"])
            lib_ms = graph_ms(torch, sdpa, sdpa_sets(torch, pa, sets),
                              args.reps)
            kv = "int8" if quant else "float32"
            print("{} {:<7} route {} device ms per call: {}  sdpa {:.4f}"
                  .format(label, kv, pa._route(s_q, d), "  ".join(
                      "{} {:.4f} (diff {:.1e})".format(
                          nm, float(np.mean(v)), errs[nm])
                      for nm, v in times.items()), lib_ms))
            split = kernel_ms(torch, kernel, sets, args.reps)
            total = float(np.mean(times["package"]))
            print("{} {:<7} package by kernel (ms a call): {}  rest of the "
                  "graph time {:.4f}".format(
                      label, kv, "  ".join("{} {:.4f}".format(k, v)
                                           for k, v in split.items()),
                      total - sum(split.values())))
    if args.split_blocks:
        blocks = [int(c) for c in args.split_blocks.split(",")]
        default = (pa.SPLIT_BLOCKS, pa.WINDOW_BLOCKS)
        try:
            for label in shapes:
                n, d, s_q, depths = SHAPES[label]
                kernel = _kernel_fn(pa, d ** -0.5)
                for quant in (False, True):
                    sets = _cases(torch, pa, dev, n, d, s_q, depths, quant,
                                  s_q + quant)
                    times = {c: [] for c in blocks}
                    for c in blocks + blocks[::-1]:
                        pa.SPLIT_BLOCKS = pa.WINDOW_BLOCKS = c
                        times[c].append(graph_ms(torch, kernel, sets,
                                                 args.reps))
                    print("{} {:<7} device ms per call by pool blocks a CTA: {}"
                          .format(label, "int8" if quant else "float32",
                                  "  ".join("C {} {:.4f}".format(
                                      c, float(np.mean(v)))
                                      for c, v in times.items())))
        finally:
            pa.SPLIT_BLOCKS, pa.WINDOW_BLOCKS = default
    if args.crossover:
        crossover(torch, pa, dev, args.reps, _build.bind_variants(
            wide, ("paged_attention",))["wide"]["paged_attention"])
    if args.trace:
        trace(torch, pa, dev, _build.bind_variants(
            traced, ("paged_attention",))["trace"]["paged_attention"],
            shapes, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

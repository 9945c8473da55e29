#!/usr/bin/env python3
"""Device time of the paged-attention query-tiled kernel at prefill
shapes, and an A/B of kernel sources within one run.

    python3 -m tensorflowonspark_tpu_torch.profile_paged \
        [--variant NAME=DIR ...] [--reps 20]

The serving model's attention widths (12 heads of 64, block 16, a table
of 64 blocks), one row, at two prefill shapes: a 256-token tail at
positions 256..511 (a prompt whose first 256 tokens hit the prefix
cache) and a cold 512-token prompt at 0..511; float32 and int8 pools,
each over 6 pool copies so that the K/V is not in L2. A source's time
is its device time per call through CUDA-graph replays; beside it,
``scaled_dot_product_attention`` on the pre-gathered view, timed the
same way (the yardstick ``chip_smoke.py`` uses; the port never calls
it). ``--variant NAME=DIR`` builds ``DIR/paged_attention.cu`` (with the
headers beside it) with the package's nvcc flags and times it in turns
with the package's own source — package, variants, variants reversed,
package — each number the mean of its source's turns, so that two
designs are compared on one card in one call. Each variant's largest
difference from the package source's output is printed beside its time
(a variant that drops work, to see what that work costs, differs).
Needs one card.
"""

import argparse
import hashlib
import os
import subprocess
import sys

import numpy as np

HEADS, HEAD_DIM, BLOCK, TABLE = 12, 64, 16, 64
#: (label, queries, position of the last one)
SHAPES = (("tail256", 256, 511), ("cold512", 512, 511))
COPIES = 6


def _build_variant(name, src_dir):
    """Compile ``src_dir/paged_attention.cu`` into the build directory
    and load it with the package library's C signatures."""
    from tensorflowonspark_tpu_torch.ops import _build

    src = os.path.join(src_dir, "paged_attention.cu")
    h = hashlib.sha256()
    for p in _build._sources(src):
        with open(p, "rb") as f:
            h.update(f.read())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, "libpaged_attention-{}-{}.so".format(
        name, h.hexdigest()[:16]))
    if not os.path.exists(lib):
        subprocess.run([_build.nvcc_path()] + list(_build.NVCC_FLAGS)
                       + ["-o", lib, src], check=True)
    return _build.bind(lib, "paged_attention")


def _cases(torch, pa, dev, s_q, last, quant, seed):
    """``COPIES`` argument sets of one row: distinct pool rows per copy
    for its live blocks, positions ``last - s_q + 1 .. last``."""
    rng = np.random.RandomState(seed)
    sets = []
    for _ in range(COPIES):
        shape = (TABLE + 1, BLOCK, HEADS, HEAD_DIM)
        q = rng.randn(1, s_q, HEADS, HEAD_DIM).astype(np.float32)
        kp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        vp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        table = (rng.permutation(TABLE) + 1).astype(np.int32)[None]
        pos = (last - s_q + 1 + np.arange(s_q, dtype=np.int32))[None]
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
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
    libs = {"package": _build.load("paged_attention")}
    for spec in args.variant:
        name, src_dir = spec.split("=", 1)
        libs[name] = _build_variant(name, src_dir)
    order = list(libs) + list(libs)[::-1]
    print(device_info.describe().splitlines()[0])
    scale = HEAD_DIM ** -0.5
    for label, s_q, last in SHAPES:
        for quant in (False, True):
            sets = _cases(torch, pa, dev, s_q, last, quant, s_q + quant)

            def kernel(q, kp, vp, t, p, ks, vs):
                return pa.paged_attention(q, kp, vp, t, p, scale=scale,
                                          impl="kernel", k_scale=ks,
                                          v_scale=vs)

            def sdpa(q, k, v, mask):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      scale=scale)

            times = {name: [] for name in libs}
            errs, want = {}, None
            for name in order:
                with _build._lock:
                    _build._libs["paged_attention"] = libs[name]
                got = kernel(*sets[0])
                if want is None:
                    want = got
                errs[name] = (got - want).abs().max().item()
                times[name].append(graph_ms(torch, kernel, sets, args.reps))
            with _build._lock:
                _build._libs["paged_attention"] = libs["package"]
            lib_ms = graph_ms(torch, sdpa, sdpa_sets(torch, pa, sets),
                              args.reps)
            print("{} {:<7} device ms per call: {}  sdpa {:.4f}".format(
                label, "int8" if quant else "float32", "  ".join(
                    "{} {:.4f} (diff {:.1e})".format(n, float(np.mean(v)),
                                                     errs[n])
                    for n, v in times.items()), lib_ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``) on one
NVIDIA card, end to end, and hold its CUDA kernels against their plain
PyTorch versions.

    python3 chip_smoke.py

Phases, stopping with a non-zero exit at the first failure:

1. card — the ``nvidia-smi`` name and power limit;
2. build — every kernel of the port, compiled from ``csrc/`` with nvcc;
3. kernel against plain version — ``paged_attention``'s CUDA kernel
   against ``_blockwise`` on the card, fp32 and int8 pools, S_q in
   {1, 16, 128}, mixed row depths, rows whose positions overshoot the
   table, an all-scratch (inactive) row; NaN-poisoned dead pool rows
   must leave the kernel's output bitwise unchanged. Then the kernel's
   time at the serving decode shape beside the plain version's, a
   ``scaled_dot_product_attention`` yardstick over the pre-gathered
   contiguous view (timed here only; the port never calls it), and
   the byte bound;
4. serving — a GPT-2-small-shaped ``DecoderLM`` (vocab 50257, hidden
   768, 12 heads, 12 layers, max_len 1024; random weights from a seed)
   behind the port's ``ModelServer``: 16 ``:generate`` requests from 4
   concurrent HTTP clients (prompts 32-512 tokens, 4 sharing a
   256-token prefix, 32-128 new tokens, greedy), once with float KV and
   once with int8 KV; then the first 8 of those requests through a
   float engine whose pool holds one slot's worth of blocks, so that
   requests are preempted and resumed. The kernel's launch count must
   grow, and the tokens must equal an ``attn_impl="gather"`` engine's
   on the same weights (a divergence is accepted only at a top-2 logit
   tie, gap below 1e-4);
5. the ``{"kernels": [...]}`` line, the card line, and last the
   ``{"ok": true, ...}`` line.

``--out-dir DIR`` also writes every number of the run to
``DIR/chip_smoke.json``. Needs one card; exits non-zero, printing no
result, without one or when the port's package is not beside this
script.
"""

import argparse

import http.client
import json
import os
import sys
import threading
import time

import numpy as np

SEED = 1234
#: |kernel - plain| bound: both compute the same fp32 online softmax
#: over the same live keys; only the summation order (per-lane fmaf
#: dot products, shuffle reductions) and expf differ, on outputs that
#: are convex combinations of unit-scale values
KERNEL_TOL = 1e-5
#: a fused/gather token divergence is accepted only at a tie this tight
TIE_GAP = 1e-4
#: H100 SXM device-memory rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 50257, 768, 12, 12, 1024
SLOTS, BLOCK = 8, 16
#: the preemption leg's pool: one slot's worth of blocks, where the 8
#: requests it serves need 164 blocks at their full lengths
PREEMPT_BLOCKS = MAX_LEN // BLOCK


def fail(msg):
    print("FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        fail(msg)


# -- phase 3: kernel against plain version ------------------------------


def make_case(torch, rng, b, s_q, mb, quant, dev, depths=None,
              overshoot_row=None, scratch_row=None):
    """Pools, tables and positions at the serving widths: each row owns
    distinct pool rows for its live blocks (scratch 0 elsewhere)."""
    n, d, bs = HEADS, HIDDEN // HEADS, BLOCK
    pool = b * mb + 1
    q = torch.from_numpy(rng.randn(b, s_q, n, d).astype("float32"))
    kp = torch.from_numpy(rng.randn(pool, bs, n, d).astype("float32"))
    vp = torch.from_numpy(rng.randn(pool, bs, n, d).astype("float32"))
    perm = rng.permutation(pool - 1) + 1
    table = perm[:b * mb].reshape(b, mb).astype("int32")
    if depths is None:
        depths = rng.randint(s_q, mb * bs + 1, size=b)
    pos = (depths[:, None] - s_q + np.arange(s_q)[None, :]).astype("int32")
    if overshoot_row is not None:
        pos[overshoot_row] = mb * bs - s_q // 2 + np.arange(s_q)
    if scratch_row is not None:
        # an inactive engine slot: table all scratch, cursor at 0
        table[scratch_row] = 0
        pos[scratch_row] = np.arange(s_q)
    for r in range(b):
        live = min((int(pos[r].max()) + bs) // bs, mb)
        if r != scratch_row:
            table[r, live:] = 0
    args = [q, kp, vp, torch.from_numpy(table), torch.from_numpy(pos)]
    scales = [None, None]
    if quant:
        from tensorflowonspark_tpu_torch.ops import paged_attention as pa
        args[1], ks = pa.quantize_kv(kp)
        args[2], vs = pa.quantize_kv(vp)
        scales = [ks, vs]
    args = [a.to(dev).contiguous() for a in args]
    scales = [s if s is None else s.to(dev).contiguous() for s in scales]
    return args, scales


def live_rows(table, pos, bs):
    """Pool rows some row of the batch may read."""
    live = set()
    for r in range(table.shape[0]):
        nblk = min((int(pos[r].max()) + bs) // bs, table.shape[1])
        live |= set(int(x) for x in table[r, :nblk])
    return live


def kernel_cases(torch, pa, dev):
    """Hold the kernel against ``_blockwise`` on every case; returns the
    largest |difference|."""
    rng = np.random.RandomState(SEED)
    worst = 0.0
    mb = MAX_LEN // BLOCK
    for quant in (False, True):
        for s_q in (1, 16, 128):
            args, (ks, vs) = make_case(
                torch, rng, SLOTS, s_q, mb, quant, dev, overshoot_row=1,
                scratch_row=SLOTS - 1)
            scale = (HIDDEN // HEADS) ** -0.5
            got = pa.paged_attention(*args, scale=scale, impl="kernel",
                                     k_scale=ks, v_scale=vs)
            want = pa.paged_attention(*args, scale=scale, impl="blockwise",
                                      k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  "kernel output not finite (s_q={}, int8={})".format(
                      s_q, quant))
            err = (got - want).abs().max().item()
            log("kernel vs plain  int8={:<5} s_q={:<3} max_abs_err={:.3e} "
                "(tol {:.0e})".format(quant, s_q, err, KERNEL_TOL))
            check(err <= KERNEL_TOL, "kernel disagrees with plain version")
            worst = max(worst, err)
            # never reads a dead pool row: poison them, output unchanged
            table = args[3].cpu().numpy()
            live = live_rows(table, args[4].cpu().numpy(), BLOCK)
            dead = torch.tensor(sorted(set(range(args[1].shape[0])) - live),
                                device=dev, dtype=torch.long)
            check(dead.numel() > 0, "case leaves no dead rows")
            pk, pv = args[1].clone(), args[2].clone()
            if quant:
                # int8 codes cannot hold NaN: poison the scales instead
                ks2, vs2 = ks.clone(), vs.clone()
                ks2[dead] = float("nan")
                vs2[dead] = float("nan")
            else:
                ks2, vs2 = ks, vs
                pk[dead] = float("nan")
                pv[dead] = float("nan")
            poisoned = pa.paged_attention(args[0], pk, pv, args[3], args[4],
                                          scale=scale, impl="kernel",
                                          k_scale=ks2, v_scale=vs2)
            torch.cuda.synchronize()
            check(torch.equal(poisoned, got),
                  "kernel output changed under NaN-poisoned dead rows "
                  "(s_q={}, int8={})".format(s_q, quant))
    return worst


def time_ms(torch, fn, sets, reps=20):
    """Mean milliseconds per call, cycling over ``sets`` argument sets
    whose live K/V together exceed the 50 MB L2 (a layer's pool is cold
    when the serving step reaches it)."""
    for a in sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for a in sets:
            fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(sets))


def kernel_timing(torch, pa, dev, quant):
    """Times at the serving decode shape: 8 slots, S_q = 1, rows at
    depths 32..640 (what the traffic's prompts plus generated tokens
    reach), block 16, table width 64."""
    import torch.nn.functional as F

    rng = np.random.RandomState(SEED + 1)
    mb = MAX_LEN // BLOCK
    depths = rng.randint(32, 641, size=SLOTS)
    sets = []
    for _ in range(6):
        args, (ks, vs) = make_case(torch, rng, SLOTS, 1, mb, quant, dev,
                                   depths=depths)
        sets.append(args + [ks, vs])
    scale = (HIDDEN // HEADS) ** -0.5

    def kernel(q, kp, vp, t, p, ks, vs):
        return pa.paged_attention(q, kp, vp, t, p, scale=scale,
                                  impl="kernel", k_scale=ks, v_scale=vs)

    def plain(q, kp, vp, t, p, ks, vs):
        return pa.paged_attention(q, kp, vp, t, p, scale=scale,
                                  impl="blockwise", k_scale=ks, v_scale=vs)

    # the library yardstick: one SDPA call over the contiguous view,
    # gathered (and dequantized) beforehand, outside the timed call
    lib_sets = []
    width = int(depths.max())
    for q, kp, vp, t, p, ks, vs in sets:
        k = kp[t.long()]
        v = vp[t.long()]
        if quant:
            k = pa.dequantize_kv(k, ks[t.long()])
            v = pa.dequantize_kv(v, vs[t.long()])
        k = k.reshape(SLOTS, -1, HEADS, HIDDEN // HEADS)[:, :width]
        v = v.reshape(SLOTS, -1, HEADS, HIDDEN // HEADS)[:, :width]
        mask = (torch.arange(width, device=dev)[None, :]
                <= p[:, :1].long())[:, None, None, :]
        lib_sets.append((q.transpose(1, 2).contiguous(),
                         k.transpose(1, 2).contiguous(),
                         v.transpose(1, 2).contiguous(), mask))

    def library(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)

    ms = time_ms(torch, kernel, sets)
    plain_ms = time_ms(torch, plain, sets, reps=5)
    library_ms = time_ms(torch, library, lib_sets)
    # the bound: each input read once, the output written once
    d = HIDDEN // HEADS
    live_tokens = int(depths.sum())  # keys at positions 0..depth-1
    kv_bytes = 2 * live_tokens * HEADS * d * (1 if quant else 4)
    if quant:
        kv_bytes += 2 * live_tokens * HEADS * 4
    io_bytes = 2 * SLOTS * HEADS * d * 4 + SLOTS * (mb + 1) * 4
    flops = 4.0 * live_tokens * HEADS * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "live_tokens": live_tokens, "kv_bytes": kv_bytes}


# -- phase 4: serving at full width -------------------------------------


def traffic():
    """16 requests: prompts 32-512 tokens (4 of them sharing one
    256-token prefix), 32-128 new tokens each."""
    rng = np.random.RandomState(SEED + 2)
    shared = rng.randint(0, VOCAB, size=256).tolist()
    reqs = []
    for i in range(16):
        n_new = int(rng.randint(32, 129))
        if i % 4 == 1:  # requests 1, 5, 9, 13 share the prefix
            prompt = shared + rng.randint(
                0, VOCAB, size=int(rng.randint(1, 257))).tolist()
        else:
            prompt = rng.randint(0, VOCAB,
                                 size=int(rng.randint(32, 513))).tolist()
        reqs.append((prompt, n_new))
    return reqs


def serve_over_http(serving, engine, reqs, clients=4):
    """Send ``reqs`` through a ModelServer from ``clients`` concurrent
    HTTP clients; returns (outputs, wall seconds)."""
    out = [None] * len(reqs)
    errors = []
    with serving.ModelServer(engine, name="gpt2") as srv:
        port = srv.address[1]

        def client(c):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
                for i in range(c, len(reqs), clients):
                    prompt, n_new = reqs[i]
                    conn.request("POST", "/v1/models/gpt2:generate",
                                 body=json.dumps({"prompt": prompt,
                                                  "max_new_tokens": n_new}),
                                 headers={"Content-Type":
                                          "application/json"})
                    resp = conn.getresponse()
                    body = json.loads(resp.read())
                    if resp.status != 200:
                        raise RuntimeError("HTTP {}: {}".format(
                            resp.status, body))
                    out[i] = body["tokens"]
                conn.close()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = conn.getresponse()
        health.read()
    check(not errors, "HTTP clients failed: {}".format(errors))
    check(health.status == 200, "/healthz answered {}".format(health.status))
    return out, wall


def top2_gap(torch, generation, model, tokens, kv_dtype, dev):
    """Top-2 logit gap after ``tokens`` (gather oracle, fresh cache)."""
    mb = MAX_LEN // BLOCK
    cache = generation.init_paged_cache(model, 1, MAX_LEN, kv_blocks=mb,
                                        block_size=BLOCK, kv_dtype=kv_dtype,
                                        device=dev)
    table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        logits = model(torch.tensor([tokens], dtype=torch.int32, device=dev),
                       cache, torch.zeros(1, dtype=torch.int32, device=dev),
                       table, attn_impl="gather")
    top = torch.topk(logits[0, -1], 2).values
    return (top[0] - top[1]).item()


def compare_tokens(torch, generation, model, fused, gather, reqs, kv_dtype,
                   dev):
    """Fused tokens must equal gather tokens, except after a tie."""
    ties = 0
    for i, ((prompt, n_new), f, g) in enumerate(zip(reqs, fused, gather)):
        check(len(f) == len(prompt) + n_new and f[:len(prompt)] == prompt,
              "request {}: malformed output".format(i))
        check(all(0 <= t < VOCAB for t in f), "token outside vocab")
        if f == g:
            continue
        first = next(j for j in range(len(f)) if f[j] != g[j])
        gap = top2_gap(torch, generation, model, f[:first], kv_dtype, dev)
        log("  request {} diverges at position {}: top-2 gap {:.3e}".format(
            i, first, gap))
        check(gap < TIE_GAP, "fused and gather tokens differ at a non-tie")
        ties += 1
    return ties


def serving_phase(torch, dev):
    from tensorflowonspark_tpu_torch import generation, serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa

    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()
    runs = {}
    # THE main path: counts at zero just before, read just after
    pa.launches = 0
    for kv in (None, "int8"):
        engine = serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                                      kv_block_size=BLOCK, kv_dtype=kv,
                                      device=dev)
        with engine:
            out, wall = serve_over_http(serving, engine, reqs)
            counts = engine.counters.snapshot()["counts"]
            runs[kv] = {"out": out, "wall": wall, "counts": counts,
                        "stages": engine.timers.snapshot(),
                        "ttft_p50": engine.histograms["ttft"].quantile(0.5),
                        "step_p50": engine.histograms["decode_step"]
                        .quantile(0.5)}
    preempt = preemption_leg(torch, serving, generation, model, reqs[:8],
                             runs[None]["out"][:8], dev)
    launches = pa.launches
    check(launches > 0, "the serving path never launched the kernel")
    for kv in (None, "int8"):
        r = runs[kv]
        gen = sum(n for _, n in reqs)
        log("serving kv={:<7} tokens/s={:.1f} wall={:.2f}s ttft_p50={:.4f}s "
            "decode_step_p50={:.4f}s prefix_hit_blocks={} preemptions={} "
            "decode_steps={}".format(
                kv or "float32", gen / r["wall"], r["wall"], r["ttft_p50"],
                r["step_p50"], r["counts"].get("prefix_hit_blocks", 0),
                r["counts"].get("preemptions", 0),
                r["counts"].get("decode_steps", 0)))
        log("  stages: " + ", ".join(
            "{} {:.3f}s/{}".format(k, v["seconds"], v["samples"])
            for k, v in sorted(r["stages"].items())))
        check(r["counts"].get("prefix_hit_blocks", 0) > 0,
              "shared-prefix requests never hit the prefix cache")
        r["tokens_per_s"] = gen / r["wall"]
        with serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                                  kv_block_size=BLOCK, kv_dtype=kv,
                                  attn_impl="gather", device=dev) as oracle:
            gather = [h.result(600) for h in
                      [oracle.submit(p, n) for p, n in reqs]]
        r["ties"] = compare_tokens(torch, generation, model, r["out"], gather,
                                   reqs, kv, dev)
        log("serving kv={:<7} fused == gather on {}/{} requests ({} at a "
            "tie)".format(kv or "float32", len(reqs) - r["ties"], len(reqs),
                          r["ties"]))
    check(pa.launches == launches, "the gather oracle launched the kernel")
    return launches, runs, preempt


def preemption_leg(torch, serving, generation, model, reqs, want, dev):
    """Serve ``reqs`` through a float engine whose pool cannot hold them
    all at full length: the youngest admissions are preempted and
    resume with a continuation prefill, and their tokens must equal the
    unpressured run's ``want`` (up to a tie)."""
    with serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                              kv_block_size=BLOCK, kv_blocks=PREEMPT_BLOCKS,
                              device=dev) as engine:
        t0 = time.monotonic()
        out = [h.result(600) for h in
               [engine.submit(p, n) for p, n in reqs]]
        wall = time.monotonic() - t0
        counts = engine.counters.snapshot()["counts"]
    preempted = counts.get("preemptions", 0)
    log("preemption kv=float32 kv_blocks={} preemptions={} prefills={} "
        "wall={:.2f}s".format(PREEMPT_BLOCKS, preempted,
                              counts.get("prefills", 0), wall))
    check(preempted > 0, "the small pool never preempted a request")
    ties = compare_tokens(torch, generation, model, out, want, reqs, None,
                          dev)
    log("preemption kv=float32 equal to the unpressured run on {}/{} "
        "requests ({} at a tie)".format(len(reqs) - ties, len(reqs), ties))
    return {"preemptions": preempted, "wall": wall, "ties": ties,
            "prefills": counts.get("prefills", 0)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default=None,
                    help="also write every number to DIR/chip_smoke.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(here, "tensorflowonspark_tpu_torch",
                                       "csrc", "paged_attention.cu")):
        print("the port's package is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa

    t_start = time.monotonic()
    card = device_info.describe().splitlines()[0]
    dev = device_info.default_device()
    log("card: " + card)
    log("torch {} cuda {}".format(torch.__version__, torch.version.cuda))

    t0 = time.monotonic()
    report = _build.build()
    log("build: {:.2f}s ({})".format(time.monotonic() - t0, ", ".join(
        "{} {:.2f}s".format(k, v["seconds"]) for k, v in report.items())))
    for name, rep in report.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("  {}: {}".format(name, line.strip()))

    max_err = kernel_cases(torch, pa, dev)
    timing = {}
    for quant in (False, True):
        timing[quant] = kernel_timing(torch, pa, dev, quant)
        t = timing[quant]
        log("decode shape int8={:<5} kernel {:.4f} ms  plain {:.4f} ms  "
            "sdpa {:.4f} ms  bound {:.4f} ms ({} live tokens, {} KV bytes / "
            "3.35 TB/s)".format(quant, t["ms"], t["plain_ms"],
                                t["library_ms"], t["bound_ms"],
                                t["live_tokens"], t["kv_bytes"]))

    launches, runs, preempt = serving_phase(torch, dev)
    t = timing[False]
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:210",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}]}
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "timing": {"float32": timing[False],
                                  "int8": timing[True]},
                       "serving": {kv or "float32": {
                           k: v for k, v in r.items() if k != "out"}
                           for kv, r in runs.items()},
                       "preemption": preempt,
                       "seconds": time.monotonic() - t_start}, f, indent=1)
    log("total: {:.1f}s".format(time.monotonic() - t_start))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

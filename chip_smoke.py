#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``) on one
NVIDIA card, end to end — serving and training — and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, stopping with a non-zero exit at the first failure:

1. card — the ``nvidia-smi`` name and power limit;
2. build — every kernel source of the port (``paged_attention.cu``,
   ``flash_attention.cu``), compiled from ``csrc/`` with nvcc, all at
   once;
3. kernel against plain version — ``paged_attention``'s CUDA kernels
   against ``_blockwise`` on the card, fp32 and int8 pools, S_q 1 (the
   split-KV route) and S_q 16 and 128 (the tensor-core query-tiled
   route) at 12 heads of 64, and S_q 16 at 4 heads of 192 (the
   CUDA-core tiled route), mixed row depths, rows whose positions
   overshoot the table, an all-scratch (inactive) row; a second call
   must be bitwise equal, and NaN-poisoned dead pool rows must leave the
   output bitwise unchanged. Then the kernels' times at the serving
   decode shape (split route) and at two prefill shapes of one row
   (tiled route): a 256-token tail at positions 256..511 and a cold
   512-token prompt at 0..511, the traffic's commonest prefill; time
   per eager call, as the flash kernels are timed, and device time
   through CUDA-graph replays beside it; the plain version's time; a
   ``scaled_dot_product_attention`` yardstick over the pre-gathered
   contiguous view, timed both ways (timed here only; the port never
   calls it); and the bound, at the float32-accurate tensor-core rate
   as for the flash kernels and at the CUDA-core float32 rate beside
   it. Then the three flash-attention kernels (forward, dQ, dK/dV)
   through the public autograd path, each against its plain
   version on the inputs it was given, on four cases: (a) the training
   shape, B 8, S 1024, 12 heads of 64, causal, float32; (b) non-causal
   rectangular S_q 128, S_k 384 with a key mask that leaves one batch
   row fully masked (lse -inf, out and grads 0); (c) case (a) in
   bfloat16; (d) a ragged S 48 at block 16. The backward takes a random
   dO and a nonzero lse cotangent. Each kernel's time at shape (a)
   beside the plain version's, one
   ``scaled_dot_product_attention(is_causal=True)`` call and its
   autograd backward (timed here only; the port never calls it), the
   bound at the float32-accurate tensor-core rate and, beside it, at
   the CUDA-core float32 rate; dQ + dK/dV over SDPA's backward; and the
   registers, spills, shared memory and CTAs per SM at D 64 of the
   three flash kernels and of the tensor-core tiled paged kernel;
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
   tie, gap below 1e-4). Every decode step must have taken the
   split-KV route and every prefill the tensor-core tiled one, once a
   layer;
5. training — the same GPT-2-small ``DecoderLM`` at full depth, float32
   with TF32 off, random weights from the seed. First one forward and
   backward on the initial weights and the first batch, once through
   the kernels and once with attention routed to the plain versions:
   same loss and gradients. Then the port's ``Trainer`` with
   ``adamw(3e-4)`` (optax's defaults, weight decay 1e-4) trains 10
   steps on batches of 8 x 1024 tokens fed through
   ``infeed.device_batches``: rows that repeat a random motif, ``y``
   ``x`` shifted by one. Every loss finite, the mean of the last 3
   below the first, each flash kernel launched exactly 12 times per
   step;
6. the ``{"kernels": [...]}`` line, the card line, and last the
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
#: the float32-accurate tensor-core rate: dense TF32 (495 TFLOP/s) over
#: the three passes of the 3xTF32 split — the attention rows' yardstick
TF32X3_FLOPS = 495e12 / 3

#: flash kernel against plain version, each on the inputs the kernel
#: was given. lse is float32 in every dtype, and float32 outputs are held
#: as max |kernel - plain| <= 1e-4 max(1, max |plain|): the forward
#: computes the same float32 products in another summation order (sums of
#: up to 1024 terms, ~1e-6 relative); the backward's 3xTF32 tensor-core
#: products are float32-accurate (each term to ~2^-21 relative; up to
#: 1.3e-5 of max |plain| measured at case (a)), where a single TF32 pass
#: would miss this limit (tests/test_torch_flash_attention.py emulates
#: both). bfloat16 outputs are held element
#: by element. Each side rounds a float32 result once to bfloat16 (7
#: stored mantissa bits: two roundings of values that differ in order
#: land at most one ulp, 2^-7 relative, apart). dq, dk, dv: |kernel -
#: plain| <= 2^-7 |plain| + 1e-3 max |plain|, the floor for order noise
#: where a sum cancels. out: both sides also round each P entry to
#: bfloat16 before P V, at different scales (the kernel against its
#: running row max, the plain version against the final lse), half an
#: ulp (2^-9 relative) each, so the products differ by at most 2^-8
#: sum_j p_j |v_j|: |kernel - plain| <= 2^-7 (|plain| + sum_j p_j |v_j|),
#: a factor 2 over that. A bfloat16 kernel that dropped one 64-key tile
#: from late rows moves lse by ~0.07 and fails the float32 limit.
FLASH_F32_RTOL = 1e-4
BF16_RTOL, BF16_FLOOR = 2.0 ** -7, 1e-3
#: kernel-attention vs plain-attention step: loss within 1e-4 relative;
#: gradients within 1e-3 of each parameter's largest, as max |kernel -
#: plain| over max |plain|. The attention runs in float32 on both routes
#: and differs in summation order only (~1e-6 relative per layer); 12
#: layers of backward and the 50257-way softmax spread that over every
#: gradient, and a key projection's gradient is a sum over positions
#: whose position-mean part cancels exactly (the key bias's gradient is
#: zero), which raises its relative error where hidden states share a
#: large mean. Checked on the initial weights.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 50257, 768, 12, 12, 1024
#: the training path's attention shape (batch, sequence)
TRAIN_BATCH, TRAIN_SEQ = 8, MAX_LEN
TRAIN_STEPS = 10
TRAIN_LR = 3e-4
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
              overshoot_row=None, scratch_row=None, n=HEADS,
              d=HIDDEN // HEADS):
    """Pools, tables and positions (the serving widths unless ``n``/``d``
    say otherwise): each row owns distinct pool rows for its live blocks
    (scratch 0 elsewhere)."""
    bs = BLOCK
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


#: (queries per row, heads, head dim, table width) of the kernel cases:
#: the split route at decode, the tensor-core tiled route at two windows
#: of the serving widths, the CUDA-core tiled route at a head dim above
#: 128 (a table of 8 blocks keeps its staged block in 48 KB)
PAGED_CASES = [(1, HEADS, HIDDEN // HEADS, MAX_LEN // BLOCK),
               (16, HEADS, HIDDEN // HEADS, MAX_LEN // BLOCK),
               (128, HEADS, HIDDEN // HEADS, MAX_LEN // BLOCK),
               (16, 4, 192, 8)]


def kernel_cases(torch, pa, dev):
    """Hold the kernels against ``_blockwise`` on every case, on every
    route (split-KV at S_q = 1, query-tiled above: tensor cores up to
    D 128, CUDA cores beyond), with a second call bitwise equal to the
    first; returns the largest |difference| per route."""
    rng = np.random.RandomState(SEED)
    worst = {route: 0.0 for route in pa.route_launches}
    for quant in (False, True):
        for s_q, n, d, mb in PAGED_CASES:
            args, (ks, vs) = make_case(
                torch, rng, SLOTS, s_q, mb, quant, dev, overshoot_row=1,
                scratch_row=SLOTS - 1, n=n, d=d)
            scale = d ** -0.5
            before = dict(pa.route_launches)
            got = pa.paged_attention(*args, scale=scale, impl="kernel",
                                     k_scale=ks, v_scale=vs)
            route = pa._route(s_q, d)
            check(route == ("split" if s_q == 1 else "tiled" if d <= 128
                            else "tiled_simt"),
                  "s_q={} D={} maps to the {} route".format(s_q, d, route))
            check(pa.route_launches[route] == before[route] + 1,
                  "s_q={} did not take the {} route".format(s_q, route))
            want = pa.paged_attention(*args, scale=scale, impl="blockwise",
                                      k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  "kernel output not finite (s_q={}, int8={})".format(
                      s_q, quant))
            err = (got - want).abs().max().item()
            again = pa.paged_attention(*args, scale=scale, impl="kernel",
                                       k_scale=ks, v_scale=vs)
            check(torch.equal(again, got), "two kernel calls on the same "
                  "inputs differ (s_q={}, int8={})".format(s_q, quant))
            log("kernel vs plain  int8={!s:<5} s_q={:<3} D={:<3} route={:<10} "
                "max_abs_err={:.3e} (tol {:.0e})".format(
                    quant, s_q, d, route, err, KERNEL_TOL))
            check(err <= KERNEL_TOL, "kernel disagrees with plain version")
            worst[route] = max(worst[route], err)
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
    when the serving step reaches it). Calls are issued from the host one
    by one, so a call whose host work outlasts its kernels measures the
    host."""
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


def paged_timing(torch, pa, dev, quant, s_q, depths, copies):
    """Times of one paged-attention call over ``len(depths)`` rows of
    ``s_q`` queries ending at ``depths`` (block 16, table width 64),
    cycling over ``copies`` pools: the kernel's time per eager call
    (``ms``) and its device time through CUDA-graph replays
    (``device_ms``), the plain version's, an SDPA yardstick timed both
    ways, and the bound."""
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.profile_paged import graph_ms, sdpa_sets

    rng = np.random.RandomState(SEED + 1 + s_q)
    b, n, d = len(depths), HEADS, HIDDEN // HEADS
    mb = MAX_LEN // BLOCK
    sets = []
    for _ in range(copies):
        args, (ks, vs) = make_case(torch, rng, b, s_q, mb, quant, dev,
                                   depths=depths)
        sets.append(args + [ks, vs])
    scale = d ** -0.5

    def kernel(q, kp, vp, t, p, ks, vs):
        return pa.paged_attention(q, kp, vp, t, p, scale=scale,
                                  impl="kernel", k_scale=ks, v_scale=vs)

    def plain(q, kp, vp, t, p, ks, vs):
        return pa.paged_attention(q, kp, vp, t, p, scale=scale,
                                  impl="blockwise", k_scale=ks, v_scale=vs)

    # the library yardstick: one SDPA call over the contiguous view,
    # gathered (and dequantized) beforehand, outside the timed call
    lib_sets = sdpa_sets(torch, pa, sets)

    def library(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)

    before = dict(pa.route_launches)
    kernel(*sets[0])
    route = [r for r in before if pa.route_launches[r] != before[r]][0]
    ms = time_ms(torch, kernel, sets)
    device_ms = graph_ms(torch, kernel, sets)
    plain_ms = time_ms(torch, plain, sets, reps=5)
    library_ms = time_ms(torch, library, lib_sets)
    library_device_ms = graph_ms(torch, library, lib_sets)
    # the bound: each input read once (the live K/V and scales, q, the
    # table, pos), the output written once; the products' flops on the
    # visible (query, key) pairs at the float32-accurate tensor-core rate
    # (bound_ms), and at the CUDA-core float32 rate (bound_simt_ms)
    pos = sets[0][4].cpu().numpy()
    live_tokens = int(sum(min(int(r.max()) + 1, mb * BLOCK) for r in pos))
    pairs = int((np.minimum(pos, mb * BLOCK - 1) + 1).sum())
    kv_bytes = 2 * live_tokens * n * d * (1 if quant else 4)
    if quant:
        kv_bytes += 2 * live_tokens * n * 4
    io_bytes = 2 * b * s_q * n * d * 4 + b * (mb + s_q) * 4
    flops = 4.0 * pairs * n * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32X3_FLOPS * 1e3
    return {"route": route, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_simt_ms": max(t_bytes, flops / FP32_FLOPS * 1e3),
            "live_tokens": live_tokens, "kv_bytes": kv_bytes,
            "flops": flops}


def kernel_timing(torch, pa, dev, quant):
    """Times at the serving decode shape: 8 slots, S_q = 1, rows at
    depths 32..640 (what the traffic's prompts plus generated tokens
    reach), over 6 pool copies so the live K/V does not sit in L2."""
    depths = np.random.RandomState(SEED + 1).randint(32, 641, size=SLOTS)
    return paged_timing(torch, pa, dev, quant, 1, depths, 6)


def prefill_timing(torch, pa, dev, quant):
    """Times at a prefill shape: one row, a 256-token tail at positions
    256..511 (a prompt whose first 256 tokens hit the prefix cache)."""
    return paged_timing(torch, pa, dev, quant, 256, np.array([512]), 6)


def cold_prefill_timing(torch, pa, dev, quant):
    """Times at the traffic's commonest prefill: one row, a cold
    512-token prompt at positions 0..511."""
    return paged_timing(torch, pa, dev, quant, 512, np.array([512]), 6)


# -- phase 3b: flash kernels against plain versions ---------------------


def flash_inputs(torch, rng, b, s_q, s_k, dtype, dev, masked_row=None):
    """q, k, v, dO, lse cotangent and key mask at 12 heads of 64."""
    n, d = HEADS, HIDDEN // HEADS

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype("float32")).to(
            dev, dtype)

    q, k, v, dout = t(b, s_q, n, d), t(b, s_k, n, d), t(b, s_k, n, d), \
        t(b, s_q, n, d)
    g_lse = torch.from_numpy(rng.randn(b, n, s_q).astype("float32")).to(dev)
    mask = None
    if masked_row is not None:
        mask = torch.from_numpy(rng.rand(b, s_k) > 0.25)
        mask[:, 0] = True
        mask[masked_row] = False
        mask = mask.to(dev)
    return q, k, v, dout, g_lse, mask


def flash_run(torch, fa, inputs, causal, block):
    """Forward and backward through the public autograd path; returns
    out, lse, dq, dk, dv."""
    q, k, v, dout, g_lse, mask = inputs
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal, key_mask=mask,
                                      block_q=block, block_k=block)
    torch.autograd.backward([out, lse], [dout, g_lse])
    return out.detach(), lse.detach(), q.grad, k.grad, v.grad


def flash_plain(fa, inputs, causal, out, lse):
    """Each kernel's plain version on the inputs that kernel was given:
    the forward on q, k, v; dQ and dK/dV also on the kernel's lse and
    the delta the backward formed from the kernel's out. Returns out,
    lse, dq, dk, dv and ``sum_j p_j |v_j|`` (the forward on |v|)."""
    q, k, v, dout, g_lse, mask = inputs
    b, s_q, n, d = q.shape
    scale = d ** -0.5
    bias = fa._mask_to_bias(mask)
    want_out, want_lse = fa._reference_lse(q, k, v, causal, scale, bias)
    lse = lse.reshape(b * n, s_q)
    delta = fa._delta(out, dout, g_lse)
    dq = fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    dk, dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    pv, _ = fa._reference_lse(q, k, v.abs(), causal, scale, bias)
    return (want_out, want_lse, dq, dk, dv), pv


FLASH_CASES = [
    # (label, b, s_q, s_k, causal, dtype, masked batch row, block)
    ("a: B8 S1024 causal fp32", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True,
     "float32", None, 128),
    ("b: S_q128 S_k384 key mask", 2, 128, 384, False, "float32", 1, 128),
    ("c: B8 S1024 causal bf16", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True,
     "bfloat16", None, 128),
    ("d: S48 block16 causal", 2, 48, 48, True, "float32", None, 16),
]


def flash_error(torch, name, got, want, dtype, pv):
    """``(max |got - want|, largest |got - want| over its limit)`` over
    the entries where ``want`` is finite (see FLASH_F32_RTOL); ``pv`` is
    ``sum_j p_j |v_j|`` per output entry."""
    fin = torch.isfinite(want)
    g, w = got.float()[fin], want.float()[fin]
    diff = (g - w).abs()
    top = w.abs().max().item()
    if dtype != "bfloat16" or name == "lse":
        limit = torch.full_like(w, FLASH_F32_RTOL * max(1.0, top))
    elif name == "out":
        limit = BF16_RTOL * (w.abs() + pv.float()[fin])
    else:
        limit = BF16_RTOL * w.abs() + BF16_FLOOR * top
    over = torch.where(diff > 0, diff / limit, torch.zeros_like(diff))
    return diff.max().item(), over.max().item()


def flash_cases(torch, fa, dev):
    """Hold the three kernels against the plain versions on every case;
    returns the largest |kernel - plain| per case letter and kernel."""
    rng = np.random.RandomState(SEED + 4)
    worst = {}
    for label, b, s_q, s_k, causal, dtype, masked, block in FLASH_CASES:
        inputs = flash_inputs(torch, rng, b, s_q, s_k,
                              getattr(torch, dtype), dev, masked)
        before = dict(fa.launches)
        got = flash_run(torch, fa, inputs, causal, block)
        torch.cuda.synchronize()
        check(fa.launches == {k: before[k] + 1 for k in before},
              "case {}: the kernels were not each launched once".format(
                  label))
        want, pv = flash_plain(fa, inputs, causal, got[0], got[1])
        torch.cuda.synchronize()
        check(fa.launches == {k: before[k] + 1 for k in before},
              "the plain versions launched a kernel")
        errs = {}
        for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            check(torch.equal(torch.isneginf(g), torch.isneginf(w)),
                  "case {}: {} -inf pattern differs".format(label, name))
            fin = torch.isfinite(w)
            check(bool(torch.isfinite(g[fin]).all()),
                  "case {}: {} not finite".format(label, name))
            errs[name] = flash_error(torch, name, g, w, dtype, pv)
        if masked is not None:
            out, lse, dq = got[0], got[1], got[2]
            check(bool(torch.isneginf(lse[masked]).all())
                  and bool((out[masked] == 0).all())
                  and bool((dq[masked] == 0).all()),
                  "case {}: the fully masked row is not lse -inf, out 0, "
                  "dq 0".format(label))
        over = max(v[1] for v in errs.values())
        log("flash vs plain  {:<28} ".format(label) + "  ".join(
            "{} {:.2e}".format(k, v[0]) for k, v in errs.items())
            + "  (error/limit " + " ".join(
                "{:.2g}".format(v[1]) for v in errs.values()) + ")")
        check(over <= 1.0, "case {}: flash kernel disagrees with plain "
              "version".format(label))
        worst[label[0]] = {"fwd": max(errs["out"][0], errs["lse"][0]),
                           "dq": errs["dq"][0],
                           "dkv": max(errs["dk"][0], errs["dv"][0])}
    return worst


def flash_timing(torch, fa, dev):
    """Each kernel's time at the training shape (a) beside its plain
    version, the SDPA yardstick and the bound."""
    import torch.nn.functional as F

    rng = np.random.RandomState(SEED + 5)
    b, s, n, d = TRAIN_BATCH, TRAIN_SEQ, HEADS, HIDDEN // HEADS
    q, k, v, dout, g_lse, _ = flash_inputs(torch, rng, b, s, s,
                                           torch.float32, dev)
    scale = d ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, None, True, scale)
    delta = fa._delta(out, dout, g_lse)
    fns = {
        "fwd": (lambda: fa._kernel_fwd(q, k, v, None, True, scale),
                lambda: fa._reference_lse(q, k, v, True, scale)),
        "dq": (lambda: fa._kernel_dq(q, k, v, None, dout, lse, delta, True,
                                     scale),
               lambda: fa._dq_plain(q, k, v, None, dout, lse, delta, True,
                                    scale)),
        "dkv": (lambda: fa._kernel_dkv(q, k, v, None, dout, lse, delta, True,
                                       scale),
                lambda: fa._dkv_plain(q, k, v, None, dout, lse, delta, True,
                                      scale)),
    }
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dout_t = dout.transpose(1, 2).contiguous()
    library = {
        "fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True),
        "dq": lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                          retain_graph=True),
    }
    # what each kernel must do on these inputs: every (query, key) pair
    # with key <= query, 2 flops per multiply-add of each product it
    # computes (forward: Q K^T, P V; dQ: Q K^T, dO V^T, dS K; dK/dV:
    # K Q^T, V dO^T, P^T dO, dS^T Q); each input read once, each output
    # written once (float32; lse and delta [B*N, S]). The operations are
    # timed at the float32-accurate tensor-core rate (bound_ms) and at
    # the CUDA-core rate (bound_simt_ms)
    pairs = b * n * s * (s + 1) // 2
    tensor = b * s * n * d * 4
    row = b * n * s * 4
    work = {"fwd": (4 * pairs * d, 4 * tensor + row),
            "dq": (6 * pairs * d, 5 * tensor + 2 * row),
            "dkv": (8 * pairs * d, 6 * tensor + 2 * row)}
    res = {}
    for name, (kern, plain) in fns.items():
        flops, nbytes = work[name]
        t_ops = flops / TF32X3_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {
            "ms": time_ms(torch, kern, [()], reps=20),
            "plain_ms": time_ms(torch, plain, [()], reps=5),
            "library_ms": (time_ms(torch, library[name], [()], reps=20)
                           if name in library else None),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_simt_ms": max(flops / FP32_FLOPS * 1e3, t_bytes),
            "flops": flops, "bytes": nbytes}
    return res


def kernel_budget(torch, fa, pa):
    """Registers, spills, shared memory and CTAs per SM of the flash
    kernels and of the tensor-core tiled paged kernel at the models'
    head dim, as the card reports them."""
    out = {}
    for quant in (False, True):
        got = pa.budget(HIDDEN // HEADS, quant)
        out["paged_tiled {}".format("int8" if quant else "float32")] = got
        log("budget paged_tiled D{} {:<7}: {} registers, {} spill bytes, {} "
            "KB shared, {} CTAs/SM".format(
                HIDDEN // HEADS, "int8" if quant else "float32",
                got["registers"], got["spill_bytes"],
                got["smem_bytes"] // 1024, got["ctas_per_sm"]))
    for kind in ("fwd", "dq", "dkv"):
        for dtype in ("float32", "bfloat16"):
            got = fa.budget(kind, HIDDEN // HEADS, getattr(torch, dtype))
            out["{} {}".format(kind, dtype)] = got
            log("budget {:<3} D{} {:<8}: {} registers, {} spill bytes, {} "
                "KB shared, {} CTAs/SM".format(
                    kind, HIDDEN // HEADS, dtype, got["registers"],
                    got["spill_bytes"], got["smem_bytes"] // 1024,
                    got["ctas_per_sm"]))
    return out


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
    for route in pa.route_launches:
        pa.route_launches[route] = 0
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
    route_launches = dict(pa.route_launches)
    check(launches > 0, "the serving path never launched the kernel")
    # every decode step (S_q = 1) takes the split-KV route and every
    # prefill (a bucket of >= 8 tokens) the query-tiled one, once a layer
    steps = sum(r["counts"].get("decode_steps", 0) for r in runs.values())
    steps += preempt["decode_steps"]
    prefills = sum(r["counts"].get("prefills", 0) for r in runs.values())
    prefills += preempt["prefills"]
    log("serving paged launches by route: {} (decode steps {}, prefills {}, "
        "{} layers)".format(route_launches, steps, prefills, LAYERS))
    check(route_launches == {"split": LAYERS * steps,
                             "tiled": LAYERS * prefills, "tiled_simt": 0},
          "decode steps did not all take the split route and prefills the "
          "tiled one")
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
    return launches, route_launches, runs, preempt


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
            "prefills": counts.get("prefills", 0),
            "decode_steps": counts.get("decode_steps", 0)}


# -- phase 5: training at full width ------------------------------------


def motif_batches(steps, batch, seq):
    """A seeded, learnable stream: each row repeats a random motif of
    16-64 tokens drawn from a pool of 256 token ids; ``y`` is ``x``
    shifted by one."""
    rng = np.random.RandomState(SEED + 3)
    pool = rng.choice(VOCAB, size=256, replace=False)
    out = []
    for _ in range(steps):
        rows = np.empty((batch, seq + 1), np.int64)
        for r in range(batch):
            motif = pool[rng.randint(0, len(pool),
                                     size=rng.randint(16, 65))]
            rows[r] = np.resize(motif, seq + 1)
        out.append({"x": rows[:, :-1].copy(), "y": rows[:, 1:].copy()})
    return out


def loss_and_grads(torch, training, model, batch, attn_impl):
    model.zero_grad(set_to_none=True)
    logits = model(batch["x"], attn_impl=attn_impl)
    loss = training.softmax_xent(logits, batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def plain_step_check(torch, training, fa, model, batch, dev):
    """One forward and backward on the initial weights and the first
    batch, attention through the kernels and then through the plain
    versions: same loss, same gradients."""
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    before = dict(fa.launches)
    k_loss, k_grads = loss_and_grads(torch, training, model, batch, "fused")
    check(all(fa.launches[k] == before[k] + LAYERS for k in before),
          "the kernel step did not launch each flash kernel once a layer")
    p_loss, p_grads = loss_and_grads(torch, training, model, batch,
                                     "gather")
    check(fa.launches == {k: before[k] + LAYERS for k in before},
          "the plain step launched a flash kernel")
    rel_loss = abs(k_loss - p_loss) / abs(p_loss)
    worst_name, worst = "", -1.0
    top = max(g.abs().max().item() for g in p_grads.values())
    for name, want in p_grads.items():
        got = k_grads[name]
        check(bool(torch.isfinite(got).all()), name + " grad not finite")
        if name.endswith("attn.key.bias"):
            # a key bias shifts every logit of a row alike: its gradient
            # is zero in exact arithmetic, and both routes return
            # rounding noise — held small against the largest gradient
            check(max(got.abs().max().item(), want.abs().max().item())
                  <= 1e-4 * top, name + " gradient is not at noise level")
            continue
        rel = (got - want).abs().max().item() / want.abs().max().item()
        if rel > worst:
            worst_name, worst = name, rel
    log("kernel vs plain attention step: loss {:.6f} vs {:.6f} (rel "
        "{:.2e}, tol {:.0e}); worst gradient {} rel {:.2e} (tol {:.0e})"
        .format(k_loss, p_loss, rel_loss, STEP_LOSS_RTOL, worst_name, worst,
                STEP_GRAD_RTOL))
    check(rel_loss <= STEP_LOSS_RTOL, "kernel and plain losses differ")
    check(worst <= STEP_GRAD_RTOL, "kernel and plain gradients differ")
    return {"loss_rel": rel_loss, "grad_rel": worst, "grad_worst": worst_name}


def training_phase(torch, dev):
    from tensorflowonspark_tpu_torch import infeed, training
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    trainer = training.Trainer(model, training.adamw(TRAIN_LR), device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
    batches = motif_batches(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    plain_step = plain_step_check(torch, training, fa, model, batches[0],
                                  dev)
    losses, step_s, counts = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # THE main path: counts at zero just before, read just after
    for name in fa.launches:
        fa.launches[name] = 0
    t0 = time.monotonic()
    for batch in infeed.device_batches(iter(batches), device=dev):
        ts = time.monotonic()
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.monotonic() - ts)
        counts.append(dict(fa.launches))
    wall = time.monotonic() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    check(len(losses) == TRAIN_STEPS, "the feed did not yield every batch")
    log("training losses: " + " ".join("{:.4f}".format(x) for x in losses))
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(np.mean(losses[-3:]) < losses[0],
          "the loss did not fall (first {:.4f}, mean of last 3 {:.4f})"
          .format(losses[0], np.mean(losses[-3:])))
    for i, c in enumerate(counts):
        check(all(c[k] == LAYERS * (i + 1) for k in c),
              "step {}: flash launches {} are not {} per kernel per step"
              .format(i + 1, c, LAYERS))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = float(np.median(step_s))
    log("training step p50 {:.4f}s  tokens/s {:.1f} (p50)  {:.1f} (10-step "
        "wall {:.2f}s)  max_memory_allocated {:.2f} GiB".format(
            p50, tokens / p50, tokens * TRAIN_STEPS / wall, wall,
            peak / 2 ** 30))
    log("training flash launches per kernel: {} over {} steps".format(
        launches, TRAIN_STEPS))
    return launches, {"losses": losses, "step_s": step_s, "p50_s": p50,
                      "tokens_per_s": tokens / p50, "wall_s": wall,
                      "max_memory_allocated": peak,
                      "plain_step": plain_step}


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
    if not all(os.path.isfile(os.path.join(
            here, "tensorflowonspark_tpu_torch", "csrc", name + ".cu"))
            for name in ("paged_attention", "flash_attention")):
        print("the port's package is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
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
    timing = {"decode": {}, "prefill": {}, "prefill_cold": {}}
    for shape, fn in (("decode", kernel_timing), ("prefill", prefill_timing),
                      ("prefill_cold", cold_prefill_timing)):
        for quant in (False, True):
            t = timing[shape][quant] = fn(torch, pa, dev, quant)
            log("{} shape int8={!s:<5} {} kernel {:.4f} ms per eager call "
                "({:.4f} ms device time)  plain {:.4f} ms  sdpa {:.4f} ms "
                "({:.4f} ms device time)  bound {:.4f} ms ({}, 3xTF32 at "
                "165 TFLOP/s; {:.4f} ms at 67; {} live tokens, {} KV bytes, "
                "{:.3g} flop)".format(
                    shape, quant, t["route"], t["ms"], t["device_ms"],
                    t["plain_ms"], t["library_ms"], t["library_device_ms"],
                    t["bound_ms"], t["bound_by"], t["bound_simt_ms"],
                    t["live_tokens"], t["kv_bytes"], t["flops"]))
    check(all(timing[shape][quant]["route"] == route
              for shape, route in (("decode", "split"), ("prefill", "tiled"),
                                   ("prefill_cold", "tiled"))
              for quant in (False, True)),
          "the decode shape must take the split route, the prefill shapes "
          "the tensor-core tiled one")
    for quant in (False, True):
        t = timing["prefill"][quant]
        log("prefill shape int8={!s:<5} tiled device time {:.4f} ms = {:.3f}"
            " x SDPA's {:.4f} ms; {:.2f}% of the {:.4f} ms bound".format(
                quant, t["device_ms"], t["device_ms"] / t["library_device_ms"],
                t["library_device_ms"], 100.0 * t["bound_ms"] / t["device_ms"],
                t["bound_ms"]))

    budget = kernel_budget(torch, fa, pa)
    flash_err = flash_cases(torch, fa, dev)
    flash_t = flash_timing(torch, fa, dev)
    for name, ft in flash_t.items():
        log("flash {:<3} at B8 S1024 causal fp32: kernel {:.4f} ms  plain "
            "{:.4f} ms  sdpa {}  bound {:.4f} ms ({}, 3xTF32 at 165 TFLOP/s; "
            "{:.4f} ms at 67; {:.3g} flop, {:.3g} B)".format(
                name, ft["ms"], ft["plain_ms"],
                "-" if ft["library_ms"] is None
                else "{:.4f} ms".format(ft["library_ms"]),
                ft["bound_ms"], ft["bound_by"], ft["bound_simt_ms"],
                ft["flops"], ft["bytes"]))
    bwd_ms = flash_t["dq"]["ms"] + flash_t["dkv"]["ms"]
    log("flash backward at B8 S1024 causal fp32: dQ + dK/dV {:.4f} ms, "
        "SDPA backward {:.4f} ms, ratio {:.3f}".format(
            bwd_ms, flash_t["dq"]["library_ms"],
            bwd_ms / flash_t["dq"]["library_ms"]))

    launches, route_launches, runs, preempt = serving_phase(torch, dev)
    torch.cuda.empty_cache()
    flash_launches, train = training_phase(torch, dev)
    t = timing["decode"][False]
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:210",
        "launches": launches,
        "max_abs_err": max(max_err.values()),
        # the decode shape (split-KV route), the main path's decode
        # steps; ms and library_ms per eager call, as for the flash rows,
        # with the device times (CUDA-graph replays) beside them
        "ms": t["ms"],
        "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_simt_ms": t["bound_simt_ms"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        # launches: calls of the wrapper, one per layer per step; a split
        # call launches two kernels, a tiled call one
        "paged_routes": {
            "split": {"kernels": ["paged_split_kernel",
                                  "paged_combine_kernel"],
                      "calls": route_launches["split"],
                      "kernel_launches": 2 * route_launches["split"],
                      "shape": "decode"},
            "tiled": {"kernels": ["paged_tiled_kernel"],
                      "calls": route_launches["tiled"],
                      "kernel_launches": route_launches["tiled"],
                      "shape": "prefill"},
            "tiled_simt": {"kernels": ["paged_attention_kernel"],
                           "calls": route_launches["tiled_simt"],
                           "kernel_launches": route_launches["tiled_simt"],
                           "shape": "head dims 129-256 (none served)"}},
        "by_shape": {shape: {"float32": timing[shape][False],
                             "int8": timing[shape][True]}
                     for shape in timing}}]}
    t = timing["prefill"][False]
    kernels["kernels"].append({
        "name": "paged_attention_tiled",
        "route": "cuda",
        "source": "tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:210",
        # the tensor-core query-tiled kernel: the serving legs' prefills
        "launches": route_launches["tiled"],
        "max_abs_err": max_err["tiled"],
        # the 256-token tail, float32; ms per eager call, device time
        # through CUDA-graph replays beside it; int8 and the cold 512
        # prompt in the paged_attention row's by_shape
        "ms": t["ms"],
        "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_simt_ms": t["bound_simt_ms"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "budget_d64": {k.split()[1]: v for k, v in budget.items()
                       if k.startswith("paged_tiled")}})
    for name, replaces, note in (
            ("fwd", 83, "scaled_dot_product_attention(is_causal=True)"),
            ("dq", 137, "autograd backward of that call: dq, dk and dv "
                        "together"),
            ("dkv", 186, "covered by the flash_dq row's library_ms")):
        ft = flash_t[name]
        kernels["kernels"].append({
            "name": "flash_" + name,
            "route": "cuda",
            "source": "tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorflowonspark_tpu/ops/flash_attention.py:{}"
                        .format(replaces),
            "launches": flash_launches[name],
            # case (a), the main path's shape and dtype; every case below
            "max_abs_err": flash_err["a"][name],
            "max_abs_err_by_case": {c: e[name] for c, e in flash_err.items()},
            "ms": ft["ms"],
            "plain_ms": ft["plain_ms"],
            "bound_ms": ft["bound_ms"],
            "bound_by": ft["bound_by"],
            "bound_simt_ms": ft["bound_simt_ms"],
            "library_ms": ft["library_ms"],
            "library": note})
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "paged_timing": {
                           shape: {"float32": timing[shape][False],
                                   "int8": timing[shape][True]}
                           for shape in timing},
                       "flash_timing": flash_t,
                       "budget": budget,
                       "serving": {kv or "float32": {
                           k: v for k, v in r.items() if k != "out"}
                           for kv, r in runs.items()},
                       "preemption": preempt,
                       "training": train,
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

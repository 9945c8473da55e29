#!/usr/bin/env python3
"""Time the flash kernels at one training shape, and A/B kernel sources
within one run.

    python3 -m tensorflowonspark_tpu_torch.profile_flash \
        [--shape bert|gpt2|d256|d256bf16|d512|d512bf16] \
        [--variant NAME=DIR ...] [--reps 20]

``--shape bert`` (the default): BERT-base's attention as
``chip_smoke.py`` phase 8 trains it, B 32, S 384, 12 heads of 64,
bfloat16, a key mask with 192-384 live keys a row (seeded), not causal.
``--shape gpt2``: the GPT-2-small decoder's as phases 5-7 train it, B 8,
S 1024, 12 heads of 64, float32, causal, no mask. ``--shape d256``: the
D-256 decoder's as phase 17(c) trains it, B 4, S 1024, 8 heads of 256,
float32, causal, no mask; ``--shape d256bf16``: the same in bfloat16, as
phase 17(a) holds the bfloat16 D-256 kernels. ``--shape d512``: the
D-512 decoder's as phase 18(d) trains it, B 2, S 1024, 8 heads of 512,
float32, causal (``csrc/wide_attention.cu``; PERF.md rows 2e-4e);
``--shape d512bf16``: the same in bfloat16 (rows 2f-4f). For the forward
(``tfos_flash_fwd``), dQ (``tfos_flash_dq``) and dK/dV
(``tfos_flash_dkv``): device time per call through CUDA-graph replays and
time per eager call (host work included).
``--variant NAME=DIR`` builds ``DIR/flash_attention.cu`` and
``DIR/wide_attention.cu``, those of them ``DIR`` holds (with the headers
beside them; the package's source stands in for a missing one), with
the package's nvcc flags, all variants at once (``ops/_build.py``
``start_variants``), and times them in turns with the package's own
sources — package, variants, variants reversed, package — each number
the mean of its sources' turns,
so that two designs are compared on one card in one call. Each variant's
largest difference from the package source's outputs (out, lse, dQ, dK,
dV) is printed beside its times (a variant that drops work, to see what
that work costs, differs), and each source's budget (``fa.budget``) at
the shape's head dim. Last, ``scaled_dot_product_attention`` with the
same boolean mask (``is_causal`` at gpt2, d256 and d256bf16), its
forward and its backward timed the same two ways (the yardstick
``chip_smoke.py`` uses; the port never calls it), and each source's dQ +
dK/dV over SDPA's backward. Needs one card.
"""

import argparse
import ctypes
import sys
import time

import numpy as np

#: (batch, sequence, heads, head dim, dtype, causal, key mask)
SHAPES = {"bert": (32, 384, 12, 64, "bfloat16", False, True),
          "gpt2": (8, 1024, 12, 64, "float32", True, False),
          "d256": (4, 1024, 8, 256, "float32", True, False),
          "d256bf16": (4, 1024, 8, 256, "bfloat16", True, False),
          "d512": (2, 1024, 8, 512, "float32", True, False),
          "d512bf16": (2, 1024, 8, 512, "bfloat16", True, False)}
SEED = 1234
#: the sources a variant may replace
SOURCES = ("flash_attention", "wide_attention")


def _inputs(torch, dev, shape):
    """q, k, v, dO and the key mask (None without one) of ``shape``."""
    batch, seq, heads, head_dim, dtype, _, masked = SHAPES[shape]
    rng = np.random.RandomState(SEED)

    def t():
        x = rng.randn(batch, seq, heads, head_dim).astype(np.float32)
        return torch.from_numpy(x).to(dev, getattr(torch, dtype))

    q, k, v, dout = t(), t(), t(), t()
    if not masked:
        return q, k, v, dout, None
    lens = torch.from_numpy(rng.randint(seq // 2, seq + 1, batch))
    mask = (torch.arange(seq)[None, :] < lens[:, None]).to(dev)
    return q, k, v, dout, mask


def eager_ms(torch, fn, reps):
    """``(ms per call, host ms per call)`` of calls issued from the host
    one by one: the first from CUDA events around them, the second the
    host's own time to issue them (the wrapper's work, as long as the
    card's queue has room)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def backward_graph_ms(torch, forward, inputs, dout, reps=20):
    """Device milliseconds of autograd's backward of ``forward(*inputs)``
    alone, by CUDA-graph replays: the forward captured in one graph and
    the backward of its output in a second, on the same capture stream
    (as ``torch.cuda.make_graphed_callables`` does), then only the second
    replayed. Autograd runs a backward on the streams its graph was built
    on, so the inputs are taken as fresh leaves (views of the same
    memory) that no graph built outside the capture has touched."""
    inputs = tuple(x.detach().requires_grad_() for x in inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            torch.autograd.grad(forward(*inputs), inputs, dout)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(fwd):
        out = forward(*inputs)
    with torch.cuda.graph(bwd, pool=fwd.pool()):
        torch.autograd.grad(out, inputs, dout, retain_graph=True)
    fwd.replay()
    bwd.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        bwd.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="bert")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.profile_paged import graph_ms

    dev = device_info.default_device()
    pending = _build.start_variants(args.variant, SOURCES)
    libs = {"package": {name: _build.load(name) for name in SOURCES}}
    libs.update(_build.bind_variants(pending, SOURCES))
    order = list(libs) + list(libs)[::-1]
    print(device_info.describe().splitlines()[0])
    causal = SHAPES[args.shape][5]
    q, k, v, dout, mask = _inputs(torch, dev, args.shape)
    bias = None if mask is None else fa._mask_to_bias(mask)
    scale = q.shape[-1] ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout)
    kernels = {
        "fwd": lambda: fa._kernel_fwd(q, k, v, bias, causal, scale),
        "dq": lambda: (fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal,
                                     scale),),
        "dkv": lambda: fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal,
                                      scale),
    }
    times = {n: {kind: ([], [], []) for kind in kernels} for n in libs}
    diffs, want = {}, None
    for name in order:
        _build.use(libs[name])
        got = sum((fn() for fn in kernels.values()), ())
        if want is None:
            want = got
        diffs[name] = max((g.float() - w.float()).nan_to_num().abs().max()
                          .item() for g, w in zip(got, want))
        for kind, fn in kernels.items():
            device, eager, host = times[name][kind]
            device.append(graph_ms(torch, fn, [()], args.reps))
            ms, host_ms = eager_ms(torch, fn, args.reps)
            eager.append(ms)
            host.append(host_ms)
    _build.use(libs["package"])
    for name in libs:
        print("{:<12} {}  (max diff from package {:.1e})".format(
            name, "  ".join(
                "{} {:.4f} ms device, {:.4f} eager, {:.4f} host".format(
                    kind, *(float(np.mean(x)) for x in t))
                for kind, t in times[name].items()), diffs[name]))
        # CTAs per SM, registers, spill bytes, shared bytes (fa.budget)
        budgets = []
        d, bf16 = q.shape[-1], int(q.dtype == torch.bfloat16)
        for i, kind in enumerate(fa.BUDGET_KINDS):
            out4 = (ctypes.c_int * 4)()
            if fa._wide(d):
                libs[name]["wide_attention"].tfos_wide_budget(
                    2 + ("fwd", "dq", "dkv").index(kind), bf16, d, out4)
            else:
                libs[name]["flash_attention"].tfos_flash_budget(i, d, bf16,
                                                                out4)
            budgets.append("{} {}".format(kind, list(out4)))
        print("{:<12} budget {}".format(name, "  ".join(budgets)))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    am = None if mask is None else mask[:, None, None, :]
    dt = dout.transpose(1, 2).contiguous()

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=am,
                                              is_causal=causal)

    fwd_device = graph_ms(torch, sdpa, [(qt, kt, vt)], args.reps)
    bwd_device = backward_graph_ms(torch, sdpa, (qt, kt, vt), dt, args.reps)
    fwd_eager = eager_ms(torch, lambda: sdpa(qt, kt, vt), args.reps)
    so = sdpa(qt, kt, vt)
    bwd_eager = eager_ms(torch, lambda: torch.autograd.grad(
        so, (qt, kt, vt), dt, retain_graph=True), args.reps)
    print("sdpa         fwd {:.4f} ms device, {:.4f} eager, {:.4f} host  bwd "
          "{:.4f} ms device, {:.4f} eager, {:.4f} host".format(
              fwd_device, *fwd_eager, bwd_device, *bwd_eager))
    for name in libs:
        device, eager = (sum(float(np.mean(times[name][kind][i]))
                             for kind in ("dq", "dkv")) for i in (0, 1))
        print("{:<12} dq+dkv {:.4f} ms device = {:.3f}x SDPA's backward, "
              "{:.4f} eager = {:.3f}x".format(
                  name, device, device / bwd_device, eager,
                  eager / bwd_eager[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/CUDA port.

    python3 -m tensorflowonspark_tpu_torch.profile_decode [--steps 20] \
        [--kv-dtype int8]

Builds the GPT-2-small-shaped ``DecoderLM`` the smoke serves (vocab
50257, hidden 768, 12 heads, 12 layers, 1024 positions; random weights
from a seed), prefills 8 slots with prompts of 32-512 tokens through
the paged step functions, then traces ``--steps`` decode steps with
``torch.profiler`` and prints: wall time per step (host clock around
synchronized steps), device-busy time per step (sum of kernel times in
the trace), and the kernels by device time. Needs one card.
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"])
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch import device_info, generation
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    dev = device_info.default_device()
    slots, total, bs = 8, 1024, 16
    mb = total // bs
    model = DecoderLM(50257, hidden=768, num_heads=12, num_layers=12,
                      max_len=total, device=dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    cache = generation.init_paged_cache(model, slots, total,
                                        block_size=bs,
                                        kv_dtype=args.kv_dtype, device=dev)
    rng = np.random.RandomState(args.seed)
    tables = np.zeros((slots, mb), np.int32)
    tables[:] = np.arange(1, slots * mb + 1).reshape(slots, mb)
    idx = np.zeros(slots, np.int32)
    last = np.zeros(slots, np.int32)
    for s in range(slots):
        n = int(rng.randint(32, 513))
        bucket = generation.bucket_for(n, generation.default_buckets(total))
        toks = np.zeros(bucket, np.int32)
        toks[:n] = rng.randint(0, 50257, size=n)
        last[s] = int(generation.paged_prefill_into_slot(
            model, cache, tables[s], toks, n, 0))
        idx[s] = n

    def step():
        out = generation.paged_decode_step(model, cache, last, idx, tables)
        out = out.cpu().numpy()
        last[:] = out
        idx[:] += 1

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    # device activities (kernels, copies) are the entries with no CPU
    # time of their own; the aten ops that launched them carry the same
    # device time again, so they are left out of the sum
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.self_cpu_time_total == 0)
    print(device_info.describe())
    print("kv_dtype={} slots={} depths {}..{} steps={}".format(
        args.kv_dtype or "float32", slots, int(idx.min()), int(idx.max()),
        args.steps))
    print("wall per step {:.3f} ms (unprofiled); device busy per step "
          "{:.3f} ms ({:.1f}% of wall)".format(
              wall_ms, dev_us / 1e3 / args.steps,
              100.0 * dev_us / 1e3 / args.steps / wall_ms))
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())

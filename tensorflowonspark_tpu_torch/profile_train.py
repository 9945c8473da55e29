#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch/CUDA port.

    python3 -m tensorflowonspark_tpu_torch.profile_train [--steps 5]

Builds the GPT-2-small ``DecoderLM`` that ``chip_smoke.py`` trains
(vocab 50257, hidden 768, 12 heads, 12 layers, 1024 positions; float32
with TF32 off; random weights from a seed), takes 2 warm-up steps of
the port's ``Trainer`` (``adamw(3e-4)``) on batches of 8 x 1024 random
tokens, times ``--steps`` steps on the host clock around synchronized
steps, then traces ``--steps`` more with ``torch.profiler`` and prints:
wall time per step, device-busy time per step (sum of kernel times in
the trace), the three flash-attention kernels' device time and share,
and the kernels by device time. Needs one card.
"""

import argparse
import sys
import time

import numpy as np

#: the training path's batch: rows x tokens, as ``chip_smoke.py`` trains
TRAIN_BATCH, TRAIN_SEQ = 8, 1024


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch import device_info, training
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    dev = device_info.default_device()
    vocab = 50257
    model = DecoderLM(vocab, hidden=768, num_heads=12, num_layers=12,
                      max_len=1024, device=dev)
    trainer = training.Trainer(model, training.adamw(3e-4), device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.RandomState(args.seed)
    rows = rng.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"x": torch.from_numpy(rows[:, :-1]).to(dev),
             "y": torch.from_numpy(rows[:, 1:]).to(dev)}

    def step():
        nonlocal state
        state, metrics = trainer.step(state, batch)
        return metrics

    for _ in range(2):
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
    device = [e for e in prof.key_averages() if e.self_cpu_time_total == 0]
    dev_us = sum(e.self_device_time_total for e in device)
    flash = {e.key: e for e in device if "flash_" in e.key}
    flash_us = sum(e.self_device_time_total for e in flash.values())
    print(device_info.describe())
    print("batch {} x {} tokens, {} steps".format(TRAIN_BATCH, TRAIN_SEQ,
                                                  args.steps))
    print("wall per step {:.3f} ms (unprofiled); device busy per step "
          "{:.3f} ms ({:.1f}% of wall)".format(
              wall_ms, dev_us / 1e3 / args.steps,
              100.0 * dev_us / 1e3 / args.steps / wall_ms))
    print("flash kernels per step {:.3f} ms ({:.1f}% of busy)".format(
        flash_us / 1e3 / args.steps, 100.0 * flash_us / max(dev_us, 1)))
    for key, e in sorted(flash.items()):
        print("  {:.3f} ms/step in {} launches/step: {}".format(
            e.self_device_time_total / 1e3 / args.steps,
            e.count // args.steps, key[:100]))
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

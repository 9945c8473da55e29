#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch/CUDA port.

    python3 -m tensorflowonspark_tpu_torch.profile_train [--steps 5]
        [--model decoder|bert|resnet50] [--seq 384]

Builds a model that ``chip_smoke.py`` trains, with random weights from
a seed (float32 products with TF32 off where the model is float32):

- ``decoder`` (default): the GPT-2-small ``DecoderLM`` (vocab 50257,
  hidden 768, 12 heads, 12 layers, 1024 positions; float32),
  ``adamw(3e-4)``, batches of 8 x 1024 random tokens;
- ``bert``: BERT-base QA (bfloat16, dropout off, so attention takes the
  flash kernels), ``adamw(3e-5)``, batches of 32 x 384 random tokens
  with 192-384 live keys a row (``--seq S``: 32 x S with S/2-S live
  keys; 64 is the ``bert_squad_spark`` example's length);
- ``resnet50``: ResNet-50 (bfloat16, float32 BatchNorm,
  ``channels_last``), SGD 0.1 with momentum 0.9, 64 random 224x224
  images.

It takes 2 warm-up steps of the port's ``Trainer``, times ``--steps``
steps on the host clock around synchronized steps, then traces
``--steps`` more with ``torch.profiler`` and prints: wall time per
step, device-busy time per step (sum of kernel times in the trace), the
three flash-attention kernels' device time and share, and the kernels
by device time. Needs one card.
"""

import argparse
import sys
import time

import numpy as np

#: the training path's batch: rows x tokens, as ``chip_smoke.py`` trains
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
BERT_BATCH, BERT_SEQ = 32, 384
RESNET_BATCH, RESNET_IMAGE = 64, 224


def _build(torch, name, dev, seed, bert_seq=BERT_SEQ):
    """``(trainer, batch, shape)`` of one model ``chip_smoke.py``
    trains."""
    from tensorflowonspark_tpu_torch import training

    rng = np.random.RandomState(seed)
    if name == "decoder":
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        vocab = 50257
        model = DecoderLM(vocab, hidden=768, num_heads=12, num_layers=12,
                          max_len=1024, device=dev)
        rows = rng.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))
        batch = {"x": rows[:, :-1], "y": rows[:, 1:]}
        trainer = training.Trainer(model, training.adamw(3e-4), device=dev)
        shape = "{} x {} tokens".format(TRAIN_BATCH, TRAIN_SEQ)
    elif name == "bert":
        from tensorflowonspark_tpu_torch.models import bert

        model = bert.BertForQuestionAnswering(
            bert.BertConfig(dropout_rate=0.0), device=dev)
        s = bert_seq
        lengths = rng.randint(s // 2, s + 1, BERT_BATCH)
        batch = {"input_ids": rng.randint(16, 30522, (BERT_BATCH, s)),
                 "attention_mask": np.arange(s)[None, :] < lengths[:, None],
                 "token_type_ids": np.zeros((BERT_BATCH, s), np.int64),
                 "start_positions": rng.randint(0, s // 2, BERT_BATCH),
                 "end_positions": rng.randint(0, s // 2, BERT_BATCH)}
        trainer = training.Trainer(
            model, training.adamw(3e-5), loss_fn=bert.qa_span_loss,
            input_keys=("input_ids", "attention_mask", "token_type_ids"),
            device=dev)
        shape = "{} x {} tokens".format(BERT_BATCH, s)
    else:
        from tensorflowonspark_tpu_torch.models import resnet

        model = resnet.ResNet50(device=dev).to(
            memory_format=torch.channels_last)
        batch = {"x": rng.rand(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE,
                               3).astype(np.float32),
                 "y": rng.randint(0, 1000, RESNET_BATCH)}
        trainer = training.Trainer(
            model, lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
            device=dev)
        shape = "{} images of {}x{}".format(RESNET_BATCH, RESNET_IMAGE,
                                            RESNET_IMAGE)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in batch.items()}
    return trainer, batch, shape


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--model", default="decoder",
                    choices=("decoder", "bert", "resnet50"))
    ap.add_argument("--seq", type=int, default=BERT_SEQ,
                    help="BERT's sequence length (--model bert)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch import device_info

    dev = device_info.default_device()
    trainer, batch, shape = _build(torch, args.model, dev, args.seed,
                                   args.seq)
    state = trainer.init(torch.Generator(device=dev).manual_seed(args.seed))

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
    print("{}: batch {}, {} steps".format(args.model, shape, args.steps))
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

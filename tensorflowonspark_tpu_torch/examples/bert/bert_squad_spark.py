"""BERT SQuAD-style fine-tune from a DataFrame text feed — the port's
copy of ``examples/bert/bert_squad_spark.py`` (``BASELINE.json`` config
3, "Spark DataFrame text feed").

The driver tokenizes host-side (ETL in the DataFrame world), feeds
(input_ids, start, end) rows through the queue plane, and every node
fine-tunes the QA span head. Synthetic QA pairs by default (nothing is
downloaded): the answer span is a repeated marker token the model must
learn to locate, in sequences of seeded lengths padded to 64, so the
attention masks keys.

``--full_size`` is BERT-base (hidden 768, 12 layers, 12 heads of 64,
bfloat16). Dropout is the config's 0.1 with a dropout stream per step,
as in the reference's example; training then runs its attention on the
einsum path. ``--dropout 0`` turns it off, and training runs its
attention through the port's flash kernels with the key mask, as the
model routes dropout-free attention: 12 launches of each kernel a step
at full size. The chief records the launches in ``train_stats.json``
beside the losses and the trainer's start-up. Run::

    python -m tensorflowonspark_tpu_torch.examples.bert.bert_squad_spark \
        --cluster_size 1 --full_size --batch_size 32 --num_examples 256 \
        [--dropout 0] [--device cpu]
"""

import argparse
import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common

VOCAB = 1024
SEQ = 64
MARKER = 7  # the "answer" token the span head must locate


def tokenize(text, vocab=VOCAB):
    """Whitespace + stable-hash tokenizer (the ETL step; a real run swaps
    in WordPiece here — the feed contract doesn't change)."""
    ids = []
    for w in text.split():
        h = 0
        for ch in w.encode("utf-8"):
            h = (h * 131 + ch) % (vocab - 16)
        ids.append(h + 16)
    return ids


def rows_from_text(path, seed=0):
    """Real-text path: tokenize each line (the DataFrame ETL step) and
    plant a marker answer span the head must learn to locate."""
    rng = np.random.RandomState(seed)
    rows = []
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        ids = tokenize(line)[:SEQ]
        if len(ids) < 8:
            continue
        start = rng.randint(0, len(ids) - 3)
        span = rng.randint(2, 4)
        for j in range(start, min(start + span, len(ids))):
            ids[j] = MARKER
        rows.append({"input_ids": ids, "start": int(start),
                     "end": int(min(start + span, len(ids)) - 1)})
    if not rows:
        raise ValueError("no usable lines in " + path)
    return rows


def synthetic_rows(n, seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        length = rng.randint(SEQ // 2, SEQ)
        ids = rng.randint(16, VOCAB, size=length)
        start = rng.randint(0, length - 3)
        span = rng.randint(2, 4)
        ids[start:start + span] = MARKER
        rows.append({"input_ids": ids.tolist(),
                     "start": int(start), "end": int(start + span - 1)})
    return rows


def map_fun(args, ctx):
    import time

    t_start = time.time()
    from tensorflowonspark_tpu_torch import infeed, training
    from tensorflowonspark_tpu_torch.models import bert
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    dev = _common.init_device(ctx, args["device"])
    cfg = bert.bert_base() if args["full_size"] else bert.bert_tiny(VOCAB)
    if args["dropout"] is not None:
        cfg.dropout_rate = args["dropout"]  # 0 takes the flash kernels
    model = bert.BertForQuestionAnswering(cfg)
    trainer = training.Trainer(
        model, training.adamw(args["lr"]), loss_fn=bert.qa_span_loss,
        input_keys=("input_ids", "attention_mask"), device=dev,
        dropout_rng=cfg.dropout_rate > 0)
    state = trainer.init(_common.generator(dev, 0))
    float(next(model.parameters()).sum())  # the init has run
    startup_s = time.time() - t_start
    feed = ctx.get_data_feed(train_mode=True)

    def batches():
        size = args["batch_size"]
        for records in feed.numpy_batches(size, pad_to_batch=True):
            ids = np.zeros((size, SEQ), np.int64)
            mask = np.zeros((size, SEQ), bool)
            start = np.zeros((size,), np.int64)
            end = np.zeros((size,), np.int64)
            for i, (row_ids, s, e) in enumerate(records):
                row_ids = row_ids[:SEQ]
                ids[i, :len(row_ids)] = row_ids
                mask[i, :len(row_ids)] = True
                start[i], end[i] = s, e
            yield {"input_ids": ids, "attention_mask": mask,
                   "start_positions": start, "end_positions": end}

    before = dict(fa.launches)
    losses, step_s, launches = [], [], []
    clock = [time.monotonic()]

    def record(n, st, metrics):
        losses.append(float(metrics["loss"]))  # waits for the step
        now = time.monotonic()
        step_s.append(now - clock[0])
        clock[0] = now
        launches.append({k: fa.launches[k] - before[k] for k in before})

    state, steps, rate = trainer.train_loop(
        state, infeed.device_batches(batches(), device=dev), log_every=10,
        hooks=(record,))
    _common.write_stats(ctx, args["model_dir"], {
        "steps": steps, "examples_per_sec": rate, "losses": losses,
        "step_s": step_s, "flash_launches": launches,
        "startup_s": startup_s, "device": str(dev),
        "config": {"hidden": cfg.hidden_size, "layers": cfg.num_layers,
                   "heads": cfg.num_heads, "dtype": str(cfg.dtype),
                   "dropout_rate": cfg.dropout_rate, "seq": SEQ}})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--num_examples", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full_size", action="store_true",
                    help="BERT-base (default: tiny config, same code path)")
    ap.add_argument("--dropout", type=float, default=None,
                    help="dropout rate (default: the config's 0.1; 0 runs "
                         "attention on the flash kernels)")
    ap.add_argument("--text_file", default=None,
                    help="tokenize real text lines instead of synthetic "
                         "pre-tokenized rows")
    ap.add_argument("--model_dir", default="bert_model")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    args.model_dir = os.path.abspath(args.model_dir)

    sc = Context(num_executors=args.cluster_size)
    try:
        tfc = cluster.run(sc, map_fun, vars(args),
                          num_executors=args.cluster_size,
                          input_mode=cluster.InputMode.SPARK)
        # DataFrame ETL: tokenized rows -> (ids, start, end) feed tuples
        rows = (rows_from_text(args.text_file) if args.text_file
                else synthetic_rows(args.num_examples))
        df = sc.createDataFrame(rows, num_slices=args.cluster_size * 2)
        rdd = df.rdd.map(lambda r: (r["input_ids"], r["start"], r["end"]))
        tfc.train(rdd, num_epochs=args.epochs)
        tfc.shutdown()
    finally:
        sc.stop()
    print("bert fine-tune complete; stats in",
          os.path.join(args.model_dir, "train_stats.json"))


if __name__ == "__main__":
    main()

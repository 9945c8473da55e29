"""MNIST map_fun: the code that runs on every cluster node — the port's
copy of ``examples/mnist/mnist_dist.py``.

Reference: ``examples/mnist/spark/mnist_dist.py`` — the ``map_fun(args,
ctx)`` convention (SURVEY.md §2.1): build the model, consume batches from
``ctx.get_data_feed()`` (InputMode.SPARK) or read files directly
(InputMode.TENSORFLOW), train, and let the chief write its stats.

Here: the port's LeNet and ``Trainer`` (Adam) on the trainer's device
(``args["device"]``: the card unless ``"cpu"``), batches through
``infeed.device_batches``, loss and step rate logged per node.
"""

import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch.examples import _common

logger = logging.getLogger(__name__)


def _parse_csv_row(row):
    """'label,p0,...,p783' -> {'x': [28,28,1] float32 in [0,1], 'y': int}"""
    vals = np.array(row.split(","), np.float32) \
        if isinstance(row, str) else np.asarray(row, np.float32)
    y = int(vals[0])
    x = (vals[1:] / 255.0).reshape(28, 28, 1).astype(np.float32)
    return {"x": x, "y": y}


def _stack(parsed):
    return {"x": np.stack([p["x"] for p in parsed]),
            "y": np.asarray([p["y"] for p in parsed], np.int64)}


def map_fun(args, ctx):
    from tensorflowonspark_tpu_torch import infeed, training
    from tensorflowonspark_tpu_torch.models.lenet import LeNet

    dev = _common.init_device(ctx, args.get("device"))
    trainer = training.Trainer(LeNet(), training.adamw(
        args["lr"], weight_decay=0.0), device=dev)
    state = trainer.init(_common.generator(dev, args.get("seed", 0)))

    if args.get("input_mode") == "tensorflow":
        batches = _file_batches(args, ctx)
    else:
        feed = ctx.get_data_feed(train_mode=True)
        batches = _feed_batches(feed, args["batch_size"])

    state, steps, rate = trainer.train_loop(
        state, infeed.device_batches(batches, device=dev),
        log_every=args.get("log_every", 50))
    logger.info("node %s done: %d steps, %.1f examples/sec",
                ctx.executor_id, steps, rate)
    _common.write_stats(ctx, args.get("model_dir"),
                        {"steps": steps, "examples_per_sec": rate,
                         "device": str(dev)})


def _feed_batches(feed, batch_size):
    """DataFeed records (CSV rows) -> stacked {'x','y'} batches, a short
    tail padded to the batch (one static shape a step)."""
    for records in feed.numpy_batches(batch_size, pad_to_batch=True):
        yield _stack([_parse_csv_row(r) for r in records])


def _file_batches(args, ctx):
    """InputMode.TENSORFLOW: read the CSV shards assigned to this worker."""
    data_dir = ctx.absolute_path(args["images"])
    parts = sorted(os.listdir(data_dir))
    mine = parts[ctx.task_sorted_index()::len(ctx.cluster_info)]
    size = args["batch_size"]
    for _ in range(args.get("epochs", 1)):
        for part in mine:
            with open(os.path.join(data_dir, part)) as f:
                rows = f.read().splitlines()
            for i in range(0, len(rows) - size + 1, size):
                yield _stack([_parse_csv_row(r) for r in rows[i:i + size]])

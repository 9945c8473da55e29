"""Distributed CIFAR-10 training — the port's copy of
``examples/cifar10/cifar10_spark.py`` (the reference's ``examples/cifar10``
analog, SURVEY.md §2.1 v1.x era), on the SPARK input mode: the driver
parallelizes (image, label) records and they stream through the feed
plane (ring/queue -> DataFeed) into a ResNet-CIFAR. The sibling
``resnet`` driver covers the same model family in InputMode.TENSORFLOW
(workers read TFRecord shards directly); this one is the cluster-fed
image path.

Records are synthetic CIFAR-shaped arrays by default (nothing is
downloaded); ``--cifar_dir`` takes a directory of TFRecord shards (raw
uint8 ``image`` + int64 ``label``) if real data is staged. Run::

    python -m tensorflowonspark_tpu_torch.examples.cifar10.cifar10_spark \
        --cluster_size 2 --num_examples 512 --batch_size 32 [--device cpu]
"""

import argparse
import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common

IMAGE, CLASSES = 32, 10


def map_fun(args, ctx):
    import torch

    from tensorflowonspark_tpu_torch import infeed, training
    from tensorflowonspark_tpu_torch.models.resnet import ResNet

    dev = _common.init_device(ctx, args["device"])
    model = ResNet(stage_sizes=[2, 2, 2], num_classes=CLASSES, width=16,
                   cifar_stem=True)
    trainer = training.Trainer(model, lambda params: torch.optim.SGD(
        params, lr=args["lr"], momentum=0.9), device=dev)
    state = trainer.init(_common.generator(dev, 0))
    feed = ctx.get_data_feed(train_mode=True)

    def batches():
        for records in feed.numpy_batches(args["batch_size"],
                                          pad_to_batch=True):
            yield {"x": np.stack([r["x"] for r in records])
                   .astype(np.float32) / 255.0,
                   "y": np.asarray([r["y"] for r in records], np.int64)}

    state, steps, rate = trainer.train_loop(
        state, infeed.device_batches(batches(), device=dev),
        log_every=args.get("log_every", 10))
    _common.write_stats(ctx, args["model_dir"],
                       {"steps": steps, "images_per_sec": rate,
                        "device": str(dev)})


def load_records(args):
    if args.cifar_dir:
        from tensorflowonspark_tpu_torch import tfrecord

        records = []
        for path in tfrecord.list_tfrecord_files(args.cifar_dir):
            for rec in tfrecord.tfrecord_iterator(path):
                ex = tfrecord.parse_example(rec)
                img = np.frombuffer(ex["image"][1][0], np.uint8)
                records.append({"x": img.reshape(IMAGE, IMAGE, 3),
                                "y": int(ex["label"][1][0])})
        return records
    rng = np.random.RandomState(0)
    return [{"x": rng.randint(0, 255, (IMAGE, IMAGE, 3), dtype=np.uint8),
             "y": int(rng.randint(CLASSES))}
            for _ in range(args.num_examples)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--num_examples", type=int, default=1024)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--cifar_dir", default=None,
                    help="TFRecord shards of real CIFAR (image/label)")
    ap.add_argument("--model_dir", default="cifar10_model")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    args.model_dir = os.path.abspath(args.model_dir)

    records = load_records(args)

    sc = Context(num_executors=args.cluster_size)
    try:
        tfc = cluster.run(sc, map_fun, vars(args),
                          num_executors=args.cluster_size,
                          input_mode=cluster.InputMode.SPARK)
        rdd = sc.parallelize(records, args.cluster_size * 2)
        tfc.train(rdd, num_epochs=args.epochs)
        tfc.shutdown()
    finally:
        sc.stop()
    print("cifar10 training complete; stats in",
          os.path.join(args.model_dir, "train_stats.json"))


if __name__ == "__main__":
    main()

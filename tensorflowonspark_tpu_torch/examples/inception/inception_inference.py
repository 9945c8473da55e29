"""Inception-v3 batch inference — the port's copy of
``examples/inception/inception_inference.py`` (``BASELINE.json`` config
5, "TFoS inference mode, Spark RDD images").

Uses the cluster *inference* path (SURVEY.md §3.3): images stream through
the queue plane, every node runs the forward over its feed, and
predictions come back as an RDD with per-partition count and order
preserved. Random-init weights from a seed by default (nothing is
downloaded) — the plumbing and throughput are what this example shows;
point ``--export_dir`` at an ``inception_train`` export to serve its
weights through the same flow. Run::

    python -m tensorflowonspark_tpu_torch.examples.inception.inception_inference \
        --cluster_size 2 --num_images 32 --image_size 75 [--device cpu]
"""

import argparse
import logging
import os
import shutil

import numpy as np

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common


def map_fun(args, ctx):
    import torch

    from tensorflowonspark_tpu_torch.models.inception import InceptionV3

    dev = _common.init_device(ctx, args["device"])
    model = InceptionV3(num_classes=args["num_classes"])
    if args["export_dir"]:
        from tensorflowonspark_tpu_torch import export

        _, variables, _ = export.load_model(args["export_dir"], device=dev)
        model.load_state_dict(variables)
    else:
        model.init_weights(_common.generator(torch.device("cpu"), 0))
    model = model.to(dev).eval()
    size = args["image_size"]

    feed = ctx.get_data_feed(train_mode=False)
    size_b = args["batch_size"]
    while not feed.should_stop():
        batch = feed.next_batch(size_b)
        if not batch:
            continue
        x = np.stack([np.frombuffer(b, np.uint8).reshape(size, size, 3)
                      for b in batch]).astype(np.float32) / 255.0
        with torch.no_grad():
            logits = model(torch.from_numpy(x).to(dev)).float()
            scores, labels = torch.log_softmax(logits, -1).max(-1)
        feed.batch_results(
            ["%d\t%.4f" % (int(lab), float(s))
             for lab, s in zip(labels.cpu(), scores.cpu())])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_images", type=int, default=64)
    ap.add_argument("--image_size", type=int, default=299,
                    help="75 for quick CPU runs; 299 = real Inception-v3")
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--export_dir", default=None)
    ap.add_argument("--output", default="inception_predictions")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    if args.export_dir:
        # trainers run from their executor workdirs; pin the path here
        args.export_dir = os.path.abspath(args.export_dir)
    args.output = os.path.abspath(args.output)

    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (args.image_size, args.image_size, 3),
                          np.uint8).tobytes() for _ in range(args.num_images)]

    sc = Context(num_executors=args.cluster_size)
    try:
        tfc = cluster.run(sc, map_fun, vars(args),
                          num_executors=args.cluster_size,
                          input_mode=cluster.InputMode.SPARK)
        rdd = sc.parallelize(images, args.cluster_size * 2)
        preds = tfc.inference(rdd)
        if os.path.exists(args.output):
            shutil.rmtree(args.output)
        preds.saveAsTextFile(args.output)
        tfc.shutdown()
    finally:
        sc.stop()
    total = 0
    for name in os.listdir(args.output):
        with open(os.path.join(args.output, name)) as f:
            total += len(f.read().splitlines())
    print("wrote {} predictions under {}".format(total, args.output))
    if total != args.num_images:
        raise RuntimeError("prediction count mismatch: {} for {} images"
                           .format(total, args.num_images))


if __name__ == "__main__":
    main()

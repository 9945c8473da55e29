"""Distributed semantic segmentation — the port's copy of
``examples/segmentation/segmentation_spark.py`` (the reference's
``examples/segmentation`` analog, the TF2 U-Net tutorial port, SURVEY.md
§2.1 v2.x era): the port's U-Net (strided-conv downsample,
ConvTranspose upsample, bfloat16 compute), cluster-fed through the
SPARK input mode.

The reference's example trains on Oxford-IIIT Pet; nothing is
downloaded here, so the driver synthesizes a shapes dataset (random
filled rectangles and ellipses on noise; classes: 0=background,
1=rectangle, 2=ellipse) — the same per-pixel 3-class problem shape.
Images and masks flow through the feed plane as ndarray records; the
chief reports the held-out mean IoU. Run::

    python -m tensorflowonspark_tpu_torch.examples.segmentation.segmentation_spark \
        --cluster_size 2 --num_examples 256 --batch_size 16 \
        --image_size 32 [--device cpu]
"""

import argparse
import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common

NUM_CLASSES = 3


def make_example(rng, size):
    """One synthetic (image, mask) pair: shapes on a noise background."""
    img = rng.rand(size, size, 3).astype(np.float32) * 0.2
    mask = np.zeros((size, size), np.uint8)
    # rectangle (class 1)
    x0, y0 = rng.randint(0, size // 2, 2)
    w, h = rng.randint(size // 4, size // 2, 2)
    color = rng.rand(3) * 0.5 + 0.5
    img[y0:y0 + h, x0:x0 + w] = color
    mask[y0:y0 + h, x0:x0 + w] = 1
    # ellipse (class 2) — drawn after, so it occludes the rectangle
    cy, cx = rng.randint(size // 4, 3 * size // 4, 2)
    ry, rx = rng.randint(size // 8, size // 4, 2)
    yy, xx = np.ogrid[:size, :size]
    ell = ((yy - cy) / max(ry, 1)) ** 2 + ((xx - cx) / max(rx, 1)) ** 2 <= 1
    img[ell] = rng.rand(3) * 0.5 + 0.5
    mask[ell] = 2
    return {"x": (img * 255).astype(np.uint8), "y": mask}


def map_fun(args, ctx):
    import torch

    from tensorflowonspark_tpu_torch import infeed, training
    from tensorflowonspark_tpu_torch.models import unet

    dev = _common.init_device(ctx, args["device"])
    model = unet.UNet(num_classes=NUM_CLASSES,
                      features=tuple(args["features"]))
    trainer = training.Trainer(model, training.adamw(
        args["lr"], weight_decay=0.0), loss_fn=unet.segmentation_loss,
        device=dev)
    state = trainer.init(_common.generator(dev, 0))
    size = args["image_size"]
    feed = ctx.get_data_feed(train_mode=True)

    def batches():
        for records in feed.numpy_batches(args["batch_size"],
                                          pad_to_batch=True):
            yield {"x": np.stack([r["x"] for r in records])
                   .astype(np.float32) / 255.0,
                   "y": np.stack([r["y"] for r in records])
                   .astype(np.int64)}

    state, steps, rate = trainer.train_loop(
        state, infeed.device_batches(batches(), device=dev),
        log_every=args.get("log_every", 10))
    if ctx.job_name == "chief":
        # held-out IoU: the metric users of the reference's example expect
        rng = np.random.RandomState(10_000)
        val = [make_example(rng, size) for _ in range(args["batch_size"])]
        vx = torch.from_numpy(np.stack([v["x"] for v in val])
                              .astype(np.float32) / 255.0).to(dev)
        vy = np.stack([v["y"] for v in val]).astype(np.int64)
        model.eval()
        with torch.no_grad():
            iou = float(unet.mean_iou(model(vx), vy, NUM_CLASSES))
        _common.write_stats(ctx, args["model_dir"],
                           {"steps": steps, "examples_per_sec": rate,
                            "val_mean_iou": iou, "device": str(dev)})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--num_examples", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--features", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--model_dir", default="segmentation_model")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    if args.image_size % (2 ** len(args.features)) != 0:
        ap.error("--image_size must be divisible by 2**len(--features)")
    args.model_dir = os.path.abspath(args.model_dir)

    rng = np.random.RandomState(0)
    records = [make_example(rng, args.image_size)
               for _ in range(args.num_examples)]

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
    print("segmentation training complete; stats in",
          os.path.join(args.model_dir, "train_stats.json"))


if __name__ == "__main__":
    main()

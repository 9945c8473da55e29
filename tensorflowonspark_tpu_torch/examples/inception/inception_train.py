"""Distributed Inception-v3 train → eval → export — the port's copy of
``examples/inception/inception_train.py`` (the reference's
``examples/imagenet/inception`` training side, SURVEY.md §2.1; the
sibling ``inception_inference`` is ``BASELINE.json`` config 5's
inference mode).

Cluster-fed (SPARK input mode) training of the port's Inception-v3, a
held-out eval pass on the chief, and a model export the inference
driver can load through ``--export_dir``. Synthetic separable data by
default (nothing is downloaded): class k images carry a class-dependent
mean shift, so a learning run beats chance by a wide margin. Run::

    python -m tensorflowonspark_tpu_torch.examples.inception.inception_train \
        --cluster_size 2 --num_examples 256 --image_size 75 \
        --num_classes 4 --export_dir inception_export [--device cpu]
"""

import argparse
import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common


def make_example(rng, size, classes):
    """Synthetic separable image: class-dependent channel mean + noise."""
    y = int(rng.randint(classes))
    # float math: integer division would floor the per-class shift to 0
    # at large --num_classes and silently train on unseparable noise
    shift = (np.arange(3) + 1.0) * (y + 1) * (160.0 / (classes + 1))
    img = np.clip(rng.normal(shift, 40.0, (size, size, 3)), 0, 255)
    return {"x": img.astype(np.uint8), "y": y}


def make_apply_fn(num_classes):
    """The export's ``apply_fn``: uint8 images in, argmax labels out, on
    a skeleton of the model (no weights of its own) called on the
    loaded variables."""

    def apply_fn(variables, batch):
        import torch

        from tensorflowonspark_tpu_torch.models.inception import InceptionV3

        skeleton = InceptionV3(num_classes=num_classes,
                               device="meta").eval()
        x = batch["image"].float() / 255.0
        with torch.no_grad():
            logits = torch.func.functional_call(skeleton, variables, (x,))
        return {"label": logits.argmax(-1)}

    return apply_fn


def map_fun(args, ctx):
    import torch

    from tensorflowonspark_tpu_torch import infeed, training
    from tensorflowonspark_tpu_torch.models.inception import InceptionV3

    dev = _common.init_device(ctx, args["device"])
    size, classes = args["image_size"], args["num_classes"]
    model = InceptionV3(num_classes=classes)
    trainer = training.Trainer(model, training.adamw(
        args["lr"], weight_decay=0.0), device=dev, dropout_rng=True)
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

    if ctx.job_name == "chief":
        from tensorflowonspark_tpu_torch import export

        # eval pass: held-out synthetic batch, same generator as training
        rng = np.random.RandomState(99_991)
        val = [make_example(rng, size, classes)
               for _ in range(args["batch_size"])]
        vx = torch.from_numpy(np.stack([v["x"] for v in val])
                              .astype(np.float32) / 255.0).to(dev)
        vy = np.asarray([v["y"] for v in val])
        model.eval()
        with torch.no_grad():
            pred = model(vx).argmax(-1).cpu().numpy()
        acc = float((pred == vy).mean())
        if args.get("export_dir"):
            export.save_model(args["export_dir"], make_apply_fn(classes),
                              dict(model.state_dict()),
                              signature={"inputs": ["image"],
                                         "outputs": ["label"]})
        _common.write_stats(ctx, args["model_dir"],
                           {"steps": steps, "images_per_sec": rate,
                            "val_accuracy": acc, "device": str(dev)})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--num_examples", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--image_size", type=int, default=299,
                    help="75 for quick CPU runs; 299 = real Inception-v3")
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--model_dir", default="inception_model")
    ap.add_argument("--export_dir", default=None,
                    help="chief exports here; feed to "
                         "inception_inference --export_dir")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    args.model_dir = os.path.abspath(args.model_dir)
    if args.export_dir:
        args.export_dir = os.path.abspath(args.export_dir)
        # clear a stale export NOW: discovering it exists only at the
        # chief's end-of-training save would waste the whole run
        if os.path.isdir(args.export_dir):
            import shutil
            shutil.rmtree(args.export_dir)

    rng = np.random.RandomState(0)
    records = [make_example(rng, args.image_size, args.num_classes)
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
    print("inception training complete; stats in",
          os.path.join(args.model_dir, "train_stats.json"))


if __name__ == "__main__":
    main()

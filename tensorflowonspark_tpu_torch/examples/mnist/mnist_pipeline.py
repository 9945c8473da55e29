"""MNIST via the Spark ML Pipeline API — fit → export → transform; the
port's copy of ``examples/mnist/mnist_pipeline.py``.

Reference: the ``examples/mnist/keras`` + ``examples/mnist/estimator``
drivers (SURVEY.md §2.1 v2.x era) exercise the high-level API family the
same way ``pipeline.TFEstimator``/``TFModel`` do here: the estimator
spins up the cluster and trains from a DataFrame, the fitted model runs
single-node parallel inference with a per-process cached export
(reference ``pipeline._run_model``, SURVEY.md §3.4). Run::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_pipeline \
        --cluster_size 2 --images data/mnist --epochs 2 [--device cpu]

(``--images`` must hold ``mnist_data_setup`` CSV output; it is written
on demand from ``--source`` when absent.) ``transform`` runs the export
in the executors, after the cluster is shut down: on the card unless
``--device cpu``.
"""

import argparse
import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common


def train_fn(args, ctx):
    """Cluster-side: LeNet over the DataFeed, the chief exports it."""
    import torch

    from tensorflowonspark_tpu_torch import export, infeed, training
    from tensorflowonspark_tpu_torch.models.lenet import LeNet

    dev = _common.init_device(ctx, args.device)
    model = LeNet()
    trainer = training.Trainer(model, training.adamw(
        args.lr, weight_decay=0.0), device=dev)
    state = trainer.init(_common.generator(dev, 0))
    feed = ctx.get_data_feed(train_mode=True)

    def batches():
        for rows in feed.numpy_batches(args.batch_size, pad_to_batch=True):
            # input_mapping order: (image, label)
            x = np.asarray([r[0] for r in rows], np.float32)
            yield {"x": (x / 255.0).reshape(-1, 28, 28, 1),
                   "y": np.asarray([r[1] for r in rows], np.int64)}

    trainer.train_loop(state, infeed.device_batches(batches(), device=dev),
                       log_every=20)

    if ctx.job_name == "chief":

        def apply_fn(variables, batch):
            import torch as _torch

            from tensorflowonspark_tpu_torch.models.lenet import LeNet as _L

            skeleton = _L(device="meta").eval()
            x = batch["image"].float() / 255.0
            with _torch.no_grad():
                logits = _torch.func.functional_call(
                    skeleton, variables, (x.reshape(-1, 28, 28, 1),))
            return {"prediction": logits.argmax(-1)}

        with torch.no_grad():
            variables = dict(model.state_dict())
        export.save_model(args.export_dir, apply_fn, variables,
                          signature={"inputs": ["image"],
                                     "outputs": ["prediction"]})


def load_csv_rows(csv_dir):
    rows = []
    for part in sorted(os.listdir(csv_dir)):
        with open(os.path.join(csv_dir, part)) as f:
            for line in f:
                vals = np.array(line.split(","), np.float32)
                rows.append({"image": vals[1:].tolist(),
                             "label": int(vals[0])})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--images", default="data/mnist")
    ap.add_argument("--num_train", type=int, default=1024,
                    help="examples to materialize when --images is absent")
    ap.add_argument("--source", default="digits",
                    help="mnist_data_setup's --source when --images is "
                         "absent (digits or synthetic)")
    ap.add_argument("--export_dir", default="mnist_pipeline_export")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    # the chief exports from its own working dir; pin the path here
    args.export_dir = os.path.abspath(args.export_dir)

    if not os.path.isdir(os.path.join(args.images, "train")):
        from tensorflowonspark_tpu_torch.examples.mnist import (
            mnist_data_setup)
        mnist_data_setup.main(["--output", args.images, "--format", "csv",
                               "--num-train", str(args.num_train),
                               "--num-test", "256",
                               "--source", args.source])

    from tensorflowonspark_tpu_torch import pipeline

    sc = Context(num_executors=args.cluster_size)
    try:
        train_df = sc.createDataFrame(
            load_csv_rows(os.path.join(args.images, "train")),
            num_slices=args.cluster_size * 2)
        est = (pipeline.TFEstimator(train_fn, {"lr": args.lr,
                                               "device": args.device})
               .setClusterSize(args.cluster_size)
               .setBatchSize(args.batch_size)
               .setEpochs(args.epochs)
               .setExportDir(args.export_dir)
               .setInputMapping({"image": "image", "label": "label"}))
        model = est.fit(train_df)
        model.device = args.device

        test_rows = load_csv_rows(os.path.join(args.images, "test"))
        test_df = sc.createDataFrame(test_rows,
                                     num_slices=args.cluster_size)
        model.setInputMapping({"image": "image"}) \
             .setOutputMapping({"prediction": "prediction"}) \
             .setBatchSize(args.batch_size)
        preds = model.transform(test_df.select("image")).collect()
        correct = sum(int(p["prediction"]) == r["label"]
                      for p, r in zip(preds, test_rows))
        acc = correct / max(len(test_rows), 1)
        print("pipeline fit+transform complete: test accuracy {:.3f} "
              "({} examples)".format(acc, len(test_rows)))
    finally:
        sc.stop()


if __name__ == "__main__":
    main()

"""MNIST driver program — the ``spark-submit``-shaped entry point; the
port's copy of ``examples/mnist/mnist_spark.py``.

Reference: ``examples/mnist/spark/mnist_spark.py`` (SURVEY.md §2.1):
argparse, ``TFCluster.run``, ``cluster.train(imageRDD)``, shutdown. Run::

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_spark \
        --cluster_size 2 --epochs 2 --images data/mnist/train \
        --batch_size 64 [--device cpu]

(``mnist_data_setup`` writes ``--images``.) Trainers train on the card
unless ``--device cpu``.
"""

import argparse
import logging
import os

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common
from tensorflowonspark_tpu_torch.examples.mnist import mnist_dist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--images", default="data/mnist/train")
    ap.add_argument("--model_dir", default="mnist_model")
    ap.add_argument("--input_mode", choices=["spark", "tensorflow"],
                    default="spark")
    ap.add_argument("--tensorboard", action="store_true")
    ap.add_argument("--log_every", type=int, default=50)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")

    tf_args = {"batch_size": args.batch_size, "lr": args.lr,
               "model_dir": os.path.abspath(args.model_dir),
               "images": os.path.abspath(args.images),
               "epochs": args.epochs, "input_mode": args.input_mode,
               "log_every": args.log_every, "device": args.device}
    input_mode = (cluster.InputMode.SPARK if args.input_mode == "spark"
                  else cluster.InputMode.TENSORFLOW)

    sc = Context(num_executors=args.cluster_size)
    try:
        tfc = cluster.run(sc, mnist_dist.map_fun, tf_args,
                          num_executors=args.cluster_size,
                          input_mode=input_mode,
                          tensorboard=args.tensorboard,
                          log_dir=args.model_dir)
        if input_mode == cluster.InputMode.SPARK:
            rows = []
            for part in sorted(os.listdir(args.images)):
                with open(os.path.join(args.images, part)) as f:
                    rows.extend(f.read().splitlines())
            rdd = sc.parallelize(rows, args.cluster_size * 2)
            tfc.train(rdd, num_epochs=args.epochs)
        tfc.shutdown()
    finally:
        sc.stop()
    print("MNIST training complete; stats in",
          os.path.join(args.model_dir, "train_stats.json"))


if __name__ == "__main__":
    main()

"""Materialize an MNIST-shaped dataset for the examples — the port's
copy of ``examples/mnist/mnist_data_setup.py``.

Reference: ``examples/mnist/mnist_data_setup.py`` downloads MNIST and
writes CSV/TFRecord copies via Spark. Nothing is downloaded here; the
source (``--source``) is one of:

- ``digits``: sklearn's bundled ``load_digits`` (1797 real 8x8
  handwritten digits) bilinearly upscaled to 28x28 and repeated to the
  requested size;
- ``synthetic``: seeded 28x28 uint8 digits-like images of 10 classes
  (a fixed stroke template per class, shifted by up to 2 pixels, with
  noise), for machines without sklearn.

Output (``--format csv|tfrecord|both``, default both — the reference
wrote both copies):

- ``<out>/{train,test}/part-*.csv`` — rows ``label,p0,...,p783`` with
  pixels in [0, 255], the shape the CSV path feeds through ``DataFeed``.
- ``<out>/{train,test}-tfr/part-*`` — TFRecord shards written through
  the port's engine with ``dfutil.saveAsTFRecords``; each Example has an
  ``image`` bytes feature (raw uint8, 784 long) and an ``int64``
  ``label``.

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_data_setup \
        --output data/mnist --source synthetic
"""

import argparse
import os

import numpy as np

SOURCES = ("digits", "synthetic")


def _digits(seed):
    """``load_digits`` upscaled to 28x28: (images in [0, 1], labels)."""
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        raise RuntimeError("--source digits needs sklearn; this machine "
                           "has none: pass --source synthetic")
    digits = load_digits()
    imgs = digits.images.astype(np.float32) / 16.0  # [1797, 8, 8] in [0,1]
    labels = digits.target.astype(np.int64)

    # bilinear 8x8 -> 28x28 without scipy: interpolate rows then cols
    def upscale(batch):
        idx = np.linspace(0, batch.shape[1] - 1, 28)
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, batch.shape[1] - 1)
        w = (idx - lo)[None, :, None]
        rows = batch[:, lo, :] * (1 - w) + batch[:, hi, :] * w
        w2 = (idx - lo)[None, None, :]
        return rows[:, :, lo] * (1 - w2) + rows[:, :, hi] * w2

    imgs28 = upscale(imgs)
    order = np.random.RandomState(seed).permutation(len(imgs28))
    return imgs28[order], labels[order]


def _synthetic(n, seed):
    """``n`` seeded digits-like images: class c is its own template of
    three strokes, shifted by up to 2 pixels, with noise."""
    rng = np.random.RandomState(seed)
    templates = np.zeros((10, 28, 28), np.float32)
    strokes = np.random.RandomState(1000).randint(4, 24, (10, 3, 4))
    for c in range(10):
        for r0, c0, r1, c1 in strokes[c]:
            rows = np.linspace(r0, r1, 24).round().astype(int)
            cols = np.linspace(c0, c1, 24).round().astype(int)
            templates[c, rows, cols] = 1.0
            templates[c, np.minimum(rows + 1, 27), cols] = 1.0
    labels = rng.randint(0, 10, n).astype(np.int64)
    shifts = rng.randint(-2, 3, (n, 2))
    imgs = np.empty((n, 28, 28), np.float32)
    for i in range(n):
        imgs[i] = np.roll(templates[labels[i]], tuple(shifts[i]), (0, 1))
    imgs = np.clip(imgs * 0.8 + rng.rand(n, 28, 28) * 0.2, 0, 1)
    return imgs, labels


def load_mnist_like(num_train=60000, num_test=10000, seed=0,
                    source="digits"):
    """Returns (x_train, y_train, x_test, y_test); x uint8 [N,28,28]."""
    if source not in SOURCES:
        raise ValueError("source must be one of {}".format(SOURCES))
    if source == "synthetic":
        x, y = _synthetic(num_train + num_test, seed)
        return ((x[:num_train] * 255).astype(np.uint8), y[:num_train],
                (x[num_train:] * 255).astype(np.uint8), y[num_train:])
    imgs28, labels = _digits(seed)
    n_test_src = max(len(imgs28) // 5, 1)
    te_x, te_y = imgs28[:n_test_src], labels[:n_test_src]
    tr_x, tr_y = imgs28[n_test_src:], labels[n_test_src:]

    def tile(x, y, n):
        reps = -(-n // len(x))
        return (np.tile(x, (reps, 1, 1))[:n], np.tile(y, reps)[:n])

    tr_x, tr_y = tile(tr_x, tr_y, num_train)
    te_x, te_y = tile(te_x, te_y, num_test)
    return ((tr_x * 255).astype(np.uint8), tr_y,
            (te_x * 255).astype(np.uint8), te_y)


def write_csv(x, y, out_dir, num_parts):
    os.makedirs(out_dir, exist_ok=True)
    flat = x.reshape(len(x), -1)
    parts = np.array_split(np.arange(len(x)), num_parts)
    for p, idx in enumerate(parts):
        with open(os.path.join(out_dir, "part-%05d.csv" % p), "w") as f:
            for i in idx:
                f.write(str(int(y[i])) + "," +
                        ",".join(str(int(v)) for v in flat[i]) + "\n")


def write_tfrecords(x, y, out_dir, num_parts, sc=None):
    """TFRecord shards via the port's engine + ``dfutil`` (the
    ``saveAsNewAPIHadoopFile`` analog). ``sc``: reuse a Context, else a
    temporary 2-executor one is spun up. Returns the records written."""
    from tensorflowonspark_tpu_torch import dfutil
    from tensorflowonspark_tpu_torch.engine import Context

    flat = x.reshape(len(x), -1)
    rows = [{"image": flat[i].tobytes(), "label": int(y[i])}
            for i in range(len(x))]
    own = sc is None
    if own:
        sc = Context(num_executors=2)
    try:
        df = sc.createDataFrame(rows, schema=[("image", "binary"),
                                              ("label", "int64")],
                                num_slices=num_parts)
        count = dfutil.saveAsTFRecords(df, out_dir)
    finally:
        if own:
            sc.stop()
    return count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", default="data/mnist")
    ap.add_argument("--num-train", type=int, default=6000)
    ap.add_argument("--num-test", type=int, default=1000)
    ap.add_argument("--num-partitions", type=int, default=4)
    ap.add_argument("--format", choices=("csv", "tfrecord", "both"),
                    default="both")
    ap.add_argument("--source", choices=SOURCES, default="digits")
    args = ap.parse_args(argv)

    x_tr, y_tr, x_te, y_te = load_mnist_like(args.num_train, args.num_test,
                                             source=args.source)
    if args.format in ("csv", "both"):
        write_csv(x_tr, y_tr, os.path.join(args.output, "train"),
                  args.num_partitions)
        write_csv(x_te, y_te, os.path.join(args.output, "test"),
                  args.num_partitions)
    if args.format in ("tfrecord", "both"):
        write_tfrecords(x_tr, y_tr, os.path.join(args.output, "train-tfr"),
                        args.num_partitions)
        write_tfrecords(x_te, y_te, os.path.join(args.output, "test-tfr"),
                        args.num_partitions)
    print("wrote {} train / {} test rows under {} ({}, {})".format(
        len(x_tr), len(x_te), args.output, args.format, args.source))


if __name__ == "__main__":
    main()

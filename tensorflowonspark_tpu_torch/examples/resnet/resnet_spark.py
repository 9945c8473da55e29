"""Distributed ResNet training — the port's copy of
``examples/resnet/resnet_spark.py`` (the reference's ``examples/resnet``
analog, the Keras multi-worker ResNet-CIFAR port; ``--imagenet`` is
``BASELINE.json`` config 2's ResNet-50 shape).

Input pipeline (InputMode.TENSORFLOW — each worker reads its own shard;
reference: ``examples/mnist/tf`` direct file reads):

- ``--data_dir DIR``: TFRecord shards (``image`` raw-uint8 bytes +
  ``label`` int64 Examples, the format ``mnist_data_setup`` and
  ``--make_data`` write); files are sharded across workers and decoded
  with the port's codec. Reader throughput goes into train_stats.json.
- default: synthetic arrays (nothing is downloaded).

``--ckpt_dir`` restores the latest checkpoint before training, saves
every ``--ckpt_every`` steps and once at the end, so a re-submitted job
resumes. ``--profile`` starts the chief's profiler endpoint
(``tracing.start_profiler_server``), writes loss and step-rate scalars
to ``<model_dir>/tb`` (a no-op without the ``tensorboard`` package) and
a ``torch.profiler`` Chrome trace of the first ``--trace_steps`` steps
to ``<model_dir>/tb/trace``. Write synthetic shards, then train from
them::

    python -m tensorflowonspark_tpu_torch.examples.resnet.resnet_spark \
        --cluster_size 2 --steps 10 --make_data 2048 \
        --data_dir data/cifar-tfr [--device cpu]
"""

import argparse
import logging
import os

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common


def make_synthetic_tfrecords(data_dir, n, image, classes, shards=4):
    """Synthetic CIFAR/ImageNet-shaped TFRecord shards (raw uint8 images)."""
    import numpy as np

    from tensorflowonspark_tpu_torch import tfrecord

    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    per = -(-n // shards)
    written = 0
    for s in range(shards):
        path = os.path.join(data_dir, "part-%05d" % s)
        with tfrecord.TFRecordWriter(path) as w:
            for _ in range(min(per, n - written)):
                img = rng.randint(0, 255, (image, image, 3), dtype=np.uint8)
                w.write(tfrecord.encode_example(
                    {"image": [img.tobytes()],
                     "label": [int(rng.randint(classes))]}))
                written += 1
    return written


def map_fun(args, ctx):
    import time

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import infeed, tfrecord, training
    from tensorflowonspark_tpu_torch.models.resnet import ResNet, ResNet50

    dev = _common.init_device(ctx, args["device"])
    if args["imagenet"]:
        model, image, classes = ResNet50(), 224, 1000
    else:
        model = ResNet(stage_sizes=[2, 2, 2], num_classes=10, width=16,
                       cifar_stem=True)
        image, classes = 32, 10
    trainer = training.Trainer(model, lambda params: torch.optim.SGD(
        params, lr=args["lr"], momentum=0.9), device=dev)
    rng = np.random.RandomState(ctx.task_index)
    reader_rate = None

    if args.get("data_dir"):
        # every worker reads its own shard of TFRecord files with the
        # port's codec; images ship as raw uint8 and scale on the device
        files = tfrecord.list_tfrecord_files(ctx.absolute_path(
            args["data_dir"]))
        my_files = files[ctx.task_sorted_index()::max(ctx.num_workers, 1)]
        if not my_files:
            raise ValueError("fewer TFRecord shards than workers; "
                             "re-shard the input")

        # reader-throughput probe: one pass over this worker's shard
        t0 = time.monotonic()
        probe = 0
        for path in my_files:
            for _ in tfrecord.tfrecord_iterator(path):
                probe += 1
        reader_rate = probe / max(time.monotonic() - t0, 1e-9)

        def record_stream():
            while True:  # epoch loop
                for path in my_files:
                    for rec in tfrecord.tfrecord_iterator(path):
                        ex = tfrecord.parse_example(rec)
                        img = np.frombuffer(ex["image"][1][0], np.uint8)
                        yield (img.reshape(image, image, 3),
                               int(ex["label"][1][0]))

        stream = record_stream()

        def batches():
            for _ in range(args["steps"]):
                pairs = [next(stream) for _ in range(args["batch_size"])]
                yield {"x": np.stack([p[0] for p in pairs])
                       .astype(np.float32) / 255.0,
                       "y": np.asarray([p[1] for p in pairs], np.int64)}
    else:
        def batches():
            for _ in range(args["steps"]):
                yield {"x": rng.rand(args["batch_size"], image, image, 3)
                       .astype(np.float32),
                       "y": rng.randint(0, classes, args["batch_size"])}

    state = trainer.init(_common.generator(dev, 0))

    # The recovery story (SURVEY.md §5 failure-detection row) at example
    # level: restore-latest before training, save every --ckpt_every
    # steps plus once at the end; a re-submitted job resumes instead of
    # restarting (reference: MonitoredTrainingSession's checkpoint dir).
    ckpt = None
    start_step = 0
    hooks = ()
    if args.get("ckpt_dir"):
        from tensorflowonspark_tpu_torch import checkpoint

        ckpt = checkpoint.Checkpointer(ctx.absolute_path(args["ckpt_dir"]),
                                       chief=ctx.job_name == "chief")
        restored = ckpt.restore(state)
        if restored is not None:
            state = restored
            start_step = int(state["step"])
        hooks = (checkpoint.hook(ckpt, args.get("ckpt_every", 50)),)

    # Observability at example level (SURVEY.md §5 tracing row): the
    # profiler endpoint, a BOUNDED trace window (--trace_steps; traces
    # of whole runs are large) and loss/step-rate summaries
    writer = None
    trace_ctx = [None]

    def _stop_trace():
        ctx_, trace_ctx[0] = trace_ctx[0], None
        if ctx_ is not None:
            ctx_.__exit__(None, None, None)

    if args.get("profile") and ctx.job_name == "chief":
        from tensorflowonspark_tpu_torch import tracing

        tb_dir = os.path.join(ctx.absolute_path(args["model_dir"]), "tb")
        tracing.start_profiler_server(0, log_dir=os.path.join(
            tb_dir, "captures"))
        writer = tracing.SummaryWriter(tb_dir)
        hooks = hooks + (tracing.metrics_hook(
            writer, every_steps=args.get("log_every", 10),
            examples_per_step=args["batch_size"]),)
        trace_ctx[0] = tracing.trace(os.path.join(tb_dir, "trace"))
        trace_ctx[0].__enter__()

        def _trace_bound(step_no, *_unused, _n=args.get("trace_steps", 20)):
            if step_no >= _n:
                _stop_trace()

        hooks = hooks + (_trace_bound,)

    try:
        state, steps, rate = trainer.train_loop(
            state, infeed.device_batches(batches(), device=dev),
            log_every=args.get("log_every", 10), hooks=hooks)
    finally:
        # a failed run keeps its trace and buffered summaries: that
        # capture is most valuable exactly when the loop raised
        _stop_trace()
        if writer is not None:
            writer.close()
    if ckpt is not None:
        ckpt.save(int(state["step"]), state, force=True)
        ckpt.wait()
        ckpt.close()
    _common.write_stats(ctx, args["model_dir"], {
        "steps": steps, "images_per_sec": rate,
        # one card a process: per device is per process
        "images_per_sec_per_device": rate,
        "reader_records_per_sec": reader_rate,
        "start_step": start_step, "end_step": int(state["step"]),
        "input": "tfrecord" if args.get("data_dir") else "synthetic",
        "device": str(dev)})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--imagenet", action="store_true",
                    help="ResNet-50/224px/1000-class (BASELINE config 2)")
    ap.add_argument("--model_dir", default="resnet_model")
    ap.add_argument("--data_dir", default=None,
                    help="TFRecord shard dir (InputMode.TENSORFLOW reads)")
    ap.add_argument("--make_data", type=int, default=0, metavar="N",
                    help="first write N synthetic TFRecord examples to "
                         "--data_dir")
    ap.add_argument("--ckpt_dir", default=None,
                    help="checkpoint/resume dir: restore-latest on start, "
                         "save every --ckpt_every steps and at the end")
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--profile", action="store_true",
                    help="chief: profiler endpoint, TensorBoard scalars "
                         "and a trace of the first --trace_steps steps")
    ap.add_argument("--trace_steps", type=int, default=20,
                    help="steps in the --profile trace window")
    ap.add_argument("--log_every", type=int, default=10)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    for name in ("model_dir", "data_dir", "ckpt_dir"):
        if getattr(args, name):
            setattr(args, name, os.path.abspath(getattr(args, name)))

    if args.make_data:
        if not args.data_dir:
            ap.error("--make_data requires --data_dir")
        image, classes = (224, 1000) if args.imagenet else (32, 10)
        n = make_synthetic_tfrecords(args.data_dir, args.make_data, image,
                                     classes,
                                     shards=max(args.cluster_size * 2, 4))
        print("wrote {} examples to {}".format(n, args.data_dir))

    sc = Context(num_executors=args.cluster_size)
    try:
        tfc = cluster.run(sc, map_fun, vars(args),
                          num_executors=args.cluster_size,
                          input_mode=cluster.InputMode.TENSORFLOW)
        tfc.shutdown()
    finally:
        sc.stop()
    print("resnet training complete; stats in",
          os.path.join(args.model_dir, "train_stats.json"))


if __name__ == "__main__":
    main()

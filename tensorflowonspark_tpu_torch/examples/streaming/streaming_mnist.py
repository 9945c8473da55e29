"""Continuous (streaming) MNIST training — the reference's Spark
Streaming mode at example level; the port's copy of
``examples/streaming/streaming_mnist.py``.

Reference capability (SURVEY.md §2 Cluster API row, §3.5):
``TFCluster.train`` accepts a DStream and feeds each micro-batch through
the same queue plane; ``shutdown(ssc)`` stops the stream before ending
the feed. Here the driver tails a spool directory with
``StreamingContext.textFileStream`` — drop new CSV part-files in and
the cluster trains on them as they arrive (the classic streaming-ingest
deployment: an upstream ETL lands files, trainers never restart).

Self-contained demo run::

    python -m tensorflowonspark_tpu_torch.examples.streaming.streaming_mnist \
        --cluster_size 2 --intervals 3 --interval_examples 256 \
        --source synthetic [--device cpu]

(``--intervals N`` synthesizes N micro-batch files into the spool dir
on a timer, then shuts down cleanly; point ``--spool_dir`` at a real
landing zone and pass ``--intervals 0`` for an open-ended run.)
"""

import argparse
import logging
import os
import threading
import time

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context, StreamingContext
from tensorflowonspark_tpu_torch.examples import _common
from tensorflowonspark_tpu_torch.examples.mnist import mnist_dist


def land_file(spool_dir, name, lines):
    """Write ``lines`` as ``spool_dir/name``, hidden while it is written
    (``.name.tmp``) and renamed when whole: the stream never reads a
    half-written file."""
    tmp = os.path.join(spool_dir, "." + name + ".tmp")
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.rename(tmp, os.path.join(spool_dir, name))


def spool_feeder(spool_dir, intervals, per_interval, interval_s,
                 source="digits"):
    """Synthesize micro-batch CSV files the way an upstream ETL would."""
    from tensorflowonspark_tpu_torch.examples.mnist import mnist_data_setup

    x, y, _, _ = mnist_data_setup.load_mnist_like(
        num_train=per_interval * intervals, num_test=1, source=source)
    # run-unique names: the stream snapshots pre-existing files at start,
    # so a re-run reusing yesterday's names would be invisible to it
    run_id = "%d-%d" % (os.getpid(), int(time.time()))
    for i in range(intervals):
        rows = []
        for j in range(i * per_interval, (i + 1) * per_interval):
            px = x[j].reshape(-1)
            rows.append(",".join([str(int(y[j]))] +
                                 [str(int(v)) for v in px]))
        land_file(spool_dir, "part-%s-%05d.csv" % (run_id, i), rows)
        time.sleep(interval_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--spool_dir", default="stream_spool")
    ap.add_argument("--model_dir", default="streaming_model")
    ap.add_argument("--intervals", type=int, default=3,
                    help="self-feed N synthesized micro-batches then stop "
                         "(0 = open-ended; feed --spool_dir externally)")
    ap.add_argument("--interval_examples", type=int, default=256)
    ap.add_argument("--interval_secs", type=float, default=2.0)
    ap.add_argument("--source", default="digits",
                    help="mnist_data_setup's --source for the self-fed "
                         "files (digits or synthetic)")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    os.makedirs(args.spool_dir, exist_ok=True)

    tf_args = {"batch_size": args.batch_size, "lr": args.lr,
               "model_dir": os.path.abspath(args.model_dir),
               "images": os.path.abspath(args.spool_dir), "epochs": 1,
               "input_mode": "spark", "log_every": 10,
               "device": args.device}

    sc = Context(num_executors=args.cluster_size)
    try:
        ssc = StreamingContext(sc, batch_interval=args.interval_secs / 2)
        tfc = cluster.run(sc, mnist_dist.map_fun, tf_args,
                          num_executors=args.cluster_size,
                          input_mode=cluster.InputMode.SPARK)
        stream = ssc.textFileStream(args.spool_dir,
                                    num_slices=args.cluster_size)
        tfc.train(stream)  # continuous: every micro-batch feeds the queues
        ssc.start()

        try:
            if args.intervals:
                feeder = threading.Thread(
                    target=spool_feeder, name="spool-feeder",
                    args=(args.spool_dir, args.intervals,
                          args.interval_examples, args.interval_secs,
                          args.source),
                    daemon=True)
                feeder.start()
                feeder.join()
                # one more interval so the final file's batch dispatches
                time.sleep(args.interval_secs)
            else:
                ssc.awaitTermination()
        except KeyboardInterrupt:
            # Ctrl-C is the documented way OUT of the open-ended mode —
            # teardown below must still run so trainers get EndFeed and
            # the chief writes its stats
            print("interrupted: shutting the stream and cluster down")

        tfc.shutdown(ssc)  # stops the stream FIRST, then ends the feed
    finally:
        sc.stop()
    print("streaming training complete; stats in",
          os.path.join(args.model_dir, "train_stats.json"))


if __name__ == "__main__":
    main()

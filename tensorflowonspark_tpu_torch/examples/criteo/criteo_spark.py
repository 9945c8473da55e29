"""Wide & Deep on Criteo-shaped data — the port's copy of
``examples/criteo/criteo_spark.py`` (BASELINE config #4, "Spark ETL ->
embedding tables").

The ETL stage runs in the DataFrame world: raw rows (13 numeric + 26
categorical string slots, tab-separated like the Criteo dump) are parsed,
log-normalized, and the categoricals hashed into embedding buckets
host-side; the queue plane then feeds integer/float tensors only, so the
device graph is gather+matmul (``models/widedeep.py``).

``--save_tfrecords DIR`` runs the ETL once into dense TFRecord shards;
``--tfrecord_dir DIR`` trains from them (InputMode.TENSORFLOW, each
worker reading its own shards with the native batched decoder).
``--quantize_export DIR`` quantizes the trained deep table to int8 and
exports a model ``ModelServer(DIR)`` serves at ``:predict``.

``--tp N`` row-shards the embedding tables (and the first MLP pair) over
a ``model`` mesh axis by ``parallel.sharding.WIDEDEEP_TP_RULES``; the
Adam moments follow the parameters' placements. **A difference from
the reference:** the reference lays ``--tp 2`` over two devices of ONE
process; the port runs one process per card, so the model axis spans
RANKS and ``--tp N`` needs ``--cluster_size`` to be a multiple of N (a
``{"data": cluster_size / N, "model": N}`` mesh). The ranks of a model
group train on one batch: with the queue feed, each step gathers the
group's batches into one.

CPU run (two gloo ranks, ``TFOS_TPU_DISTRIBUTED=1`` forms the group)::

    python -m tensorflowonspark_tpu_torch.examples.criteo.criteo_spark \
        --cluster_size 2 --tp 2 --quantize_export wd_int8 --device cpu
"""

import argparse
import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context
from tensorflowonspark_tpu_torch.examples import _common

BUCKETS = 1000


def synthetic_criteo_lines(n, seed=0):
    """Tab-separated: label, 13 ints (some blank), 26 hex categoricals.
    The label correlates with dense[0] and cat[0] so training can learn."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        d0 = rng.randint(0, 100)
        c0 = rng.randint(0, 8)
        label = 1 if (d0 > 50) ^ (c0 < 2) else 0
        dense = [str(d0)] + [str(rng.randint(0, 1000)) if rng.rand() > 0.1
                             else "" for _ in range(12)]
        cats = ["%08x" % c0] + ["%08x" % rng.randint(0, 500)
                                for _ in range(25)]
        lines.append("\t".join([str(label)] + dense + cats))
    return lines


def etl(line, buckets=BUCKETS):
    """One raw line -> (dense[13] float32, cat[26] int64, label) tuple."""
    from tensorflowonspark_tpu_torch.models.widedeep import hash_categorical

    parts = line.rstrip("\n").split("\t")
    label = int(parts[0])
    dense = np.array([np.log1p(float(v)) if v else 0.0
                      for v in parts[1:14]], np.float32)
    cat = hash_categorical(parts[14:40], buckets)
    return dense, cat, label


def save_tfrecords(lines, out_dir, shards=4, buckets=BUCKETS):
    """ETL once, materialize dense tensors as TFRecord shards — the
    reference workflow of persisting the ETL output for repeated
    training runs (dfutil.saveAsTFRecords analog, dense schema)."""
    from tensorflowonspark_tpu_torch import tfrecord

    os.makedirs(out_dir, exist_ok=True)
    per = -(-len(lines) // shards)
    for s in range(shards):
        rows = lines[s * per:(s + 1) * per]
        tfrecord.write_tfrecords(
            os.path.join(out_dir, "part-%05d" % s),
            ({"dense": dense, "cat": cat, "label": [label]}
             for dense, cat, label in (etl(r, buckets) for r in rows)))


def _make_model(args, quantized=False, device=None):
    """The ONE WideDeep constructor both training and export use — a
    config drift between them would surface as a state_dict mismatch at
    serve time, the worst place to find it."""
    from tensorflowonspark_tpu_torch.models import widedeep

    return widedeep.WideDeep(
        hash_buckets=args.get("hash_buckets", BUCKETS),
        embed_dim=args.get("embed_dim", 16),
        mlp_sizes=(64, 32), quantized=quantized, device=device)


def _build_trainer(args, ctx):
    """(device, mesh, trainer, state): a ``{"data": -1, "model": tp}``
    mesh over the ranks (``{"data": n}`` at tp 1), weights from the seed,
    and at tp > 1 the tables row-sharded by WIDEDEEP_TP_RULES before the
    optimizer is built, so its moments take the same placements (the
    reference's ``_shard_params``; sharding only the parameters would
    leave 2/3 of the table bytes replicated at recommender scale)."""
    import torch

    from tensorflowonspark_tpu_torch import training
    from tensorflowonspark_tpu_torch.models import widedeep
    from tensorflowonspark_tpu_torch.parallel import sharding

    dev = _common.init_device(ctx, args["device"])
    tp = int(args.get("tp", 1))
    mesh = ctx.mesh({"data": -1, "model": tp} if tp > 1 else None)
    lr = args["lr"]
    trainer = training.Trainer(
        _make_model(args), lambda p: torch.optim.Adam(p, lr=lr),
        loss_fn=widedeep.ctr_loss, input_keys=("dense", "cat"), device=dev,
        mesh=mesh)
    state = trainer.init(_common.generator(dev, 0))
    if tp > 1:
        sharding.distribute_params(state.model, mesh,
                                   sharding.WIDEDEEP_TP_RULES)
        state = trainer.init()  # the optimizer over the sharded params
    return dev, mesh, trainer, state


def _mesh_axis(mesh, axis):
    """(size, this rank's index, group) of ``axis``, or (1, 0, None)."""
    from tensorflowonspark_tpu_torch.parallel.collectives import axis_of

    if axis not in mesh.mesh_dim_names:
        return 1, 0, None
    return axis_of(mesh, axis)


def _fed_batches(batches, mesh, dev):
    """The queue feed's batches for the trainer. Alone: prefetched onto
    the device (``infeed.device_batches``). Under a group of several
    ranks: only while EVERY rank still has one (an all-reduce of the
    flag each step: ranks whose feeds run dry at different points must
    stop together, or the gradient collectives deadlock), each one the
    model group's batches concatenated, so the ranks of a model group
    step on the same data — in the trainer's own thread, since the
    collectives must keep one order with the step's (the step moves the
    batch to the device itself)."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import infeed

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return infeed.device_batches(batches, device=dev)
    m_size, _, m_group = _mesh_axis(mesh, "model")

    def agreed():
        for batch in batches:
            have = torch.ones(1, device=dev)  # NCCL: on the card
            dist.all_reduce(have, op=dist.ReduceOp.MIN)
            if not have.item():
                return
            if m_size > 1:
                parts = [None] * m_size
                dist.all_gather_object(parts, batch, group=m_group)
                batch = {k: np.concatenate([p[k] for p in parts])
                         for k in batch}
            yield batch
        have = torch.zeros(1, device=dev)  # ran dry: the others stop
        dist.all_reduce(have, op=dist.ReduceOp.MIN)

    return agreed()


def _quantize_export(args, ctx, state):
    """Post-training int8 table quantization + model export (the chief
    writes; every rank takes part in gathering sharded tables).

    The recommender serving journey (SURVEY §2.2 quantized lookups):
    trained float params -> quantize_embeddings -> export; serve with
    ``ModelServer(DIR)`` and the logits track the float model's within
    quantization error. Rerunnable: an existing export dir is replaced.
    """
    out_dir = args.get("quantize_export")
    if not out_dir:
        return
    import shutil

    from torch.distributed.tensor import DTensor

    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.models import widedeep

    # TP-sharded tables span ranks: gather them (a collective) first
    full = {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach()
            for k, v in state.model.state_dict().items()}
    if ctx.job_name != "chief":
        return
    slim, quant = widedeep.quantize_embeddings(full)
    cfg = {k: args.get(k) for k in ("hash_buckets", "embed_dim")
           if args.get(k) is not None}
    built = {}

    def apply_fn(variables, batch, _cfg=cfg):
        import numpy as np
        import torch
        from torch.func import functional_call

        from tensorflowonspark_tpu_torch.examples.criteo import (
            criteo_spark as _criteo)

        model = built.get("model")
        if model is None:
            model = built["model"] = _criteo._make_model(
                dict(_cfg), quantized=True, device="meta").eval()
        dev = next(iter(variables.values())).device
        logit = functional_call(model, variables, (
            torch.as_tensor(np.asarray(batch["dense"], np.float32)).to(dev),
            torch.as_tensor(np.asarray(batch["cat"], np.int64)).to(dev)))
        return {"ctr_logit": logit}

    out = ctx.absolute_path(out_dir)
    if os.path.isdir(out):
        shutil.rmtree(out)
    export.save_model(out, apply_fn, dict(slim, **quant),
                      signature={"inputs": ["dense", "cat"],
                                 "outputs": ["ctr_logit"]})


def _stats(args, ctx, dev, mesh, state, payload):
    table = state.model.deep_embeddings.weight
    local = table.to_local() if hasattr(table, "to_local") else table
    payload.update({
        "table_rows": 26 * args.get("hash_buckets", BUCKETS),
        "table_local_rows": int(local.shape[0]),
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "device": str(dev)})
    _common.write_stats(ctx, args["model_dir"], payload)


def map_fun_tfrecord(args, ctx):
    """InputMode.TENSORFLOW trainer: each data replica reads its own
    dense TFRecord shards with the native batched decoder
    (tfrecord.read_batch), no queue plane in the loop."""
    import time

    from tensorflowonspark_tpu_torch import infeed, tfrecord

    dev, mesh, trainer, state = _build_trainer(args, ctx)
    files = tfrecord.list_tfrecord_files(
        ctx.absolute_path(args["tfrecord_dir"]))
    # the shards split over the DATA axis: a model group's ranks read the
    # same files, so they step on the same batches
    d_size, d_rank, _ = _mesh_axis(mesh, "data")
    mine = files[d_rank::d_size]
    if not mine:
        raise ValueError("fewer TFRecord shards than data replicas")
    schema = {"dense": ("float32", 13), "cat": ("int64", 26),
              "label": ("int64", 1)}
    t0 = time.monotonic()
    cols = [tfrecord.read_batch(f, schema) for f in mine]
    dense = np.concatenate([c["dense"] for c in cols])
    cat = np.concatenate([c["cat"] for c in cols])
    label = np.concatenate([c["label"] for c in cols])[:, 0] \
        .astype(np.float32)
    read_rate = len(dense) / (time.monotonic() - t0)

    # SPMD discipline: every rank must run the SAME number of steps or
    # the gradient all-reduce deadlocks on uneven shards. Every rank
    # counts every shard (metadata-rate native index) and they agree on
    # the smallest replica's batches; local data wraps circularly.
    # verify_crc=False: a COUNT of all shards by all ranks; the shards a
    # rank trains on were CRC-validated by its read_batch above.
    shard_counts = [tfrecord.count_records(f, verify_crc=False)
                    for f in files]
    replica_counts = [sum(shard_counts[w::d_size]) for w in range(d_size)]
    b = args["batch_size"]
    steps = max(1, args["epochs"] * (min(replica_counts) // b))

    def batches():
        i = 0
        n = len(dense)
        for _ in range(steps):
            idx = np.arange(i, i + b) % n
            i = (i + b) % n
            yield {"dense": dense[idx], "cat": cat[idx], "label": label[idx]}

    state, steps, rate = trainer.train_loop(
        state, infeed.device_batches(batches(), device=dev), log_every=20)
    _stats(args, ctx, dev, mesh, state, {
        "steps": steps, "examples_per_sec": rate,
        "reader_records_per_sec": read_rate, "input": "tfrecord"})
    _quantize_export(args, ctx, state)


def map_fun(args, ctx):
    dev, mesh, trainer, state = _build_trainer(args, ctx)
    feed = ctx.get_data_feed(train_mode=True)

    def batches():
        b = args["batch_size"]
        for records in feed.numpy_batches(b, pad_to_batch=True):
            yield {"dense": np.stack([r[0] for r in records]),
                   "cat": np.stack([r[1] for r in records]),
                   "label": np.array([r[2] for r in records], np.float32)}

    state, steps, rate = trainer.train_loop(
        state, _fed_batches(batches(), mesh, dev), log_every=20)
    if not feed.should_stop():
        feed.terminate()  # stopped with the others: drain what is left
    _stats(args, ctx, dev, mesh, state, {
        "steps": steps, "examples_per_sec": rate,
        "feed_stats": feed.stats(), "input": "spark-etl"})
    _quantize_export(args, ctx, state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster_size", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--num_examples", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--hash_buckets", type=int, default=BUCKETS,
                    help="buckets per categorical slot; the fused table "
                         "holds 26x this many rows (385000 ~= a 10M-row "
                         "table)")
    ap.add_argument("--embed_dim", type=int, default=16)
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size; >1 row-shards the embedding "
                         "tables over the ranks (WIDEDEEP_TP_RULES); "
                         "--cluster_size must be a multiple of it")
    ap.add_argument("--quantize_export", default=None, metavar="DIR",
                    help="after training, quantize the deep embedding "
                         "table to int8 and export a servable model to "
                         "DIR (the chief writes; serve with ModelServer)")
    ap.add_argument("--data", default=None,
                    help="path to a Criteo-format text file (default: "
                         "synthetic)")
    ap.add_argument("--save_tfrecords", default=None, metavar="DIR",
                    help="run the ETL once and materialize dense TFRecord "
                         "shards to DIR, then exit (no training)")
    ap.add_argument("--tfrecord_dir", default=None, metavar="DIR",
                    help="train from dense TFRecord shards written by "
                         "--save_tfrecords (InputMode.TENSORFLOW; each "
                         "data replica reads its own shards via the "
                         "native batched decoder)")
    ap.add_argument("--model_dir", default="widedeep_model")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level="INFO")
    if args.cluster_size % args.tp:
        ap.error("--tp {} needs --cluster_size to be a multiple of it (the "
                 "model axis spans ranks); got {}".format(
                     args.tp, args.cluster_size))
    for name in ("model_dir", "tfrecord_dir", "quantize_export",
                 "save_tfrecords"):
        if getattr(args, name):
            setattr(args, name, os.path.abspath(getattr(args, name)))

    def load_lines():  # only the ETL-consuming paths pay for this
        if args.data:
            with open(args.data) as f:
                return f.read().splitlines()
        return synthetic_criteo_lines(args.num_examples)

    if args.save_tfrecords:
        save_tfrecords(load_lines(), args.save_tfrecords,
                       shards=max(4, args.cluster_size),
                       buckets=args.hash_buckets)
        print("wrote dense TFRecord shards to", args.save_tfrecords)
        return

    sc = Context(num_executors=args.cluster_size)
    try:
        if args.tfrecord_dir:
            tfc = cluster.run(sc, map_fun_tfrecord, vars(args),
                              num_executors=args.cluster_size,
                              input_mode=cluster.InputMode.TENSORFLOW)
            tfc.shutdown()
            print("widedeep tfrecord training complete; stats in",
                  os.path.join(args.model_dir, "train_stats.json"))
            return  # finally: sc.stop()
        tfc = cluster.run(sc, map_fun, vars(args),
                          num_executors=args.cluster_size,
                          input_mode=cluster.InputMode.SPARK)
        # Spark-ETL stage: raw lines -> hashed tensors, on the executors
        buckets = args.hash_buckets
        rdd = sc.parallelize(load_lines(), args.cluster_size * 2).map(
            lambda line, _b=buckets: etl(line, _b))
        tfc.train(rdd, num_epochs=args.epochs)
        tfc.shutdown()
    finally:
        sc.stop()
    print("wide&deep training complete; stats in",
          os.path.join(args.model_dir, "train_stats.json"))


if __name__ == "__main__":
    main()

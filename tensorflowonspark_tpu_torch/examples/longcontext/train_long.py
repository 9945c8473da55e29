"""Driver for the long-context ring+flash LM example — the port's copy of
``examples/longcontext/train_long.py``. Run::

    python -m tensorflowonspark_tpu_torch.examples.longcontext.train_long \
        --seq_len 2048 [--layout zigzag] [--seq_ranks N] [--device cpu]

The ``seq`` mesh axis spans ``--seq_ranks`` processes on this host (one
card each; default 1, a one-rank ring on the card) that the driver
starts itself, each joining one process group (NCCL on the cards, gloo
on the CPU) — the port's counterpart of the reference's ``seq`` axis
over a slice's chips, whose KV rotation rides ICI. The last line of the
output is a JSON object with every step's loss and wall seconds, the
flash kernels rank 0 launched a step, tokens/s and the peak memory.
Exits non-zero if the loss does not fall.
"""

import argparse
import datetime
import json
import os
import statistics
import sys
import tempfile


def _rank_main(rank, world, port, kwargs, out_path):
    """One rank of a ``--seq_ranks`` ring: join the group, train, and
    (rank 0) write the stats."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.examples.longcontext import long_dist

    cuda = kwargs.get("device") != "cpu"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        kwargs = dict(kwargs, device="cuda:{}".format(
            rank % torch.cuda.device_count()))
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method="tcp://127.0.0.1:{}".format(port), world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        stats = {}
        long_dist.train(stats=stats, **kwargs)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(stats, f)
    finally:
        dist.destroy_process_group()


def run(kwargs, seq_ranks):
    """Train on ``seq_ranks`` ranks; returns rank 0's stats."""
    import torch.multiprocessing as mp

    from tensorflowonspark_tpu_torch import util

    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "stats.json")
        if seq_ranks == 1:
            _rank_main(0, 1, util.find_free_port(), kwargs, out_path)
        else:
            mp.start_processes(_rank_main, nprocs=seq_ranks, join=True,
                               args=(seq_ranks, util.find_free_port(),
                                     kwargs, out_path),
                               start_method="spawn")
        with open(out_path) as f:
            return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq_len", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--period", type=int, default=37)
    ap.add_argument("--layout", choices=["contiguous", "zigzag"],
                    default="contiguous",
                    help="zigzag: load-balanced causal ring (~2x less "
                         "causal wall time on a real ring)")
    ap.add_argument("--seq_ranks", type=int, default=1,
                    help="processes the seq axis spans on this host, one "
                         "card each (the CPU under --device cpu)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (gloo ranks); the "
                         "cards by default")
    args = ap.parse_args(argv)

    kwargs = dict(seq_len=args.seq_len, batch=args.batch, steps=args.steps,
                  hidden=args.hidden, layers=args.layers,
                  period=args.period, layout=args.layout,
                  device=args.device)
    stats = run(kwargs, args.seq_ranks)
    first, last = stats["losses"][0], stats["losses"][-1]
    # the first step builds the kernels and warms the allocator
    p50 = statistics.median(stats["step_s"][1:] or stats["step_s"])
    stats["step_p50_s"] = p50
    stats["tokens_per_s"] = args.batch * args.seq_len / p50
    print("first loss %.4f -> last loss %.4f" % (first, last))
    print(json.dumps(stats), flush=True)
    if last >= first:
        raise SystemExit("loss did not improve")


if __name__ == "__main__":
    sys.exit(main())

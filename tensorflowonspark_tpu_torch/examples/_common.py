"""Helpers the example drivers share: the ``--device`` flag, the
trainer's device, seeded weights on it, and the chief's
``train_stats.json``. Importing this module imports no torch (the
executors import it)."""

import json
import os


def add_device_flag(ap):
    ap.add_argument("--device", default=None,
                    help="where the trainers run: the card by default, "
                         "'cpu' on a machine without one")


def init_device(ctx, device):
    """``ctx.initialize_torch(device)``; a trainer on the CPU then takes
    its share of the host's cores, and no more threads than the process
    was given (``OMP_NUM_THREADS``): the cluster's trainers share one
    host, and as many spinning thread pools as trainers would each want
    every core."""
    import torch

    dev = ctx.initialize_torch(device)
    if dev.type == "cpu":
        share = (os.cpu_count() or 1) // max(len(ctx.cluster_info), 1)
        torch.set_num_threads(max(1, min(share, torch.get_num_threads())))
    return dev


def generator(dev, seed=0):
    """A ``torch.Generator`` on ``dev`` seeded with ``seed`` — what
    ``Trainer.init`` draws the weights from."""
    import torch

    gen = torch.Generator(device=dev) if dev.type == "cuda" \
        else torch.Generator()
    return gen.manual_seed(seed)


def write_stats(ctx, model_dir, stats):
    """The chief writes ``<model_dir>/train_stats.json``; other roles
    write nothing."""
    if ctx.job_name != "chief" or not model_dir:
        return
    out = ctx.absolute_path(model_dir)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "train_stats.json"), "w") as f:
        json.dump(stats, f)

#!/usr/bin/env python3
"""Tensor-parallel collective traffic of the port, measured: the bytes
each collective family moves in one megatron-sharded BERT training step
at each TP width, and the bytes one decode step moves under
``DECODER_TP_RULES``.

    python3 -m tensorflowonspark_tpu_torch.tp_scaling_model --sweep 2,4
    python3 -m tensorflowonspark_tpu_torch.tp_scaling_model --tp 2 \
        --device cpu

Each width runs in a fresh group of ``tp`` spawned ranks, one a process:
on the cards by default (NCCL, one rank a card; fewer cards than ``tp``
is refused), or with ``--device cpu`` as gloo ranks on the CPU.
BERT-tiny for question answering with ``BERT_TP_RULES`` on a
``{"data": 1, "model": tp}`` mesh takes one ``Trainer`` step on a
seeded batch of B 8 x S 32, inside a
``parallel.collectives.CollectiveRecorder``, which counts the calls and
output bytes of every collective DTensor and the port issue (the port's
counterpart of reading XLA's HLO). Megatron's model says the step's
traffic is activation-shaped: about 4 all-reduces of one ``[B, S, H]``
activation a layer (2 forward, 2 backward), whatever ``tp`` is, with
the ring's own factor ``2 (tp - 1) / tp`` on the wire left aside;
``bytes_per_layer_per_activation`` reads how the measured step tracks
it. The embedding table is sharded on its hidden dim, so the step also
gathers activations.

The decode row lays a ``DecoderLM`` (L 2, H 64, 4 heads, B 8) out by
``DECODER_TP_RULES`` and records one cached decode step: its bytes must
be the megatron count, 2 all-reduces x L x B x H x 4 bytes (one after
``attn.out``, one after ``mlp_out``, each of the float32 ``[B, 1, H]``
partial sums).

The bytes are counts of payload, not times: no interconnect rate is
assumed, and nothing here projects onto a device.
"""

import argparse
import json
import os
import sys
import tempfile
import time

#: the training step's batch (the reference script's shape)
BATCH, SEQ = 8, 32
#: the decode row's model and batch
DECODE = {"vocab": 64, "hidden": 64, "heads": 4, "layers": 2,
          "max_len": 32, "batch": 8, "prompt": 4}
#: seconds a width's ranks must finish within (each pays torch's import)
RANK_TIMEOUT = 300


def decode_step_traffic(model, seq, device=None):
    """Teacher-force ``seq`` (``[B, S]`` tokens, ``S >= 2``) through
    ``model`` (laid out on a mesh, or not) over a fresh cache:
    ``seq[:, :-1]`` in one cached forward, then ``seq[:, -1:]`` as one
    decode step inside a ``CollectiveRecorder``. Returns ``{"logits":
    [B, S - 1, V] of the first forward (this rank's plain tensor),
    "families": {family: {"ops", "bytes"}}, "bytes": total}`` — the
    step's traffic is what one new token of each of the B rows costs.
    Runs on ``device`` (None: the card; ``"cpu"`` must be asked for),
    where the model or its mesh must already live."""
    import torch

    from tensorflowonspark_tpu_torch import device_info, generation
    from tensorflowonspark_tpu_torch.parallel.collectives import (
        CollectiveRecorder)

    dev = device_info.default_device(device)
    seq = torch.as_tensor(seq, dtype=torch.int32, device=dev)
    b, s = seq.shape
    if s < 2:
        raise ValueError("decode_step_traffic needs S >= 2, got {}".format(s))
    cache = generation.init_cache(model, b, s, device=dev)
    forward = generation.cached_forward(model)
    with torch.no_grad():
        logits = forward(seq[:, :-1], cache)
        with CollectiveRecorder() as rec:
            forward(seq[:, -1:], cache)
    return {"logits": logits, "families": rec.families,
            "bytes": rec.total_bytes}


def megatron_decode_bytes(layers, batch, hidden):
    """Payload bytes one decode step moves under the megatron split: two
    all-reduces a layer of the float32 ``[B, 1, H]`` partial sums."""
    return 2 * layers * batch * hidden * 4


def _bert_step(tp, dev):
    """One BERT_TP_RULES training step on this group's ``tp`` ranks."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import training
    from tensorflowonspark_tpu_torch.models import bert
    from tensorflowonspark_tpu_torch.parallel import build_mesh, sharding
    from tensorflowonspark_tpu_torch.parallel.collectives import (
        CollectiveRecorder)

    mesh = build_mesh({"data": 1, "model": tp})
    cfg = bert.bert_tiny()
    model = bert.BertForQuestionAnswering(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    sharding.distribute_params(model, mesh, sharding.BERT_TP_RULES)
    rng = np.random.RandomState(0)
    batch = {
        "input_ids": rng.randint(0, cfg.vocab_size, (BATCH, SEQ))
        .astype(np.int64),
        "attention_mask": np.ones((BATCH, SEQ), bool),
        "start_positions": rng.randint(0, SEQ, (BATCH,)).astype(np.int64),
        "end_positions": rng.randint(0, SEQ, (BATCH,)).astype(np.int64)}
    trainer = training.Trainer(
        model, training.adamw(1e-4), loss_fn=bert.qa_span_loss,
        input_keys=("input_ids", "attention_mask"), device=dev,
        dropout_rng=True, mesh=mesh)
    state = trainer.init()
    with CollectiveRecorder() as rec:
        state, metrics = trainer.step(state, batch)
    loss = float(metrics["loss"])
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    act = BATCH * SEQ * cfg.hidden_size * itemsize
    total = rec.total_bytes
    return {
        "tp": tp,
        "step_executed": bool(np.isfinite(loss)),
        "loss": loss,
        "layers": cfg.num_layers,
        # one [B, S, H] activation in the model's dtype (bfloat16)
        "activation_bytes": act,
        "collectives": rec.families,
        "total_collective_bytes": total,
        "bytes_per_layer_per_activation": round(
            total / cfg.num_layers / act, 3)}


def _decode_row(tp, dev):
    """The decode row on this group's ``tp`` ranks."""
    import copy

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
    from tensorflowonspark_tpu_torch.parallel import build_mesh, sharding

    c = DECODE
    base = DecoderLM(c["vocab"], hidden=c["hidden"], num_heads=c["heads"],
                     num_layers=c["layers"], max_len=c["max_len"])
    base.init_weights(torch.Generator().manual_seed(0))
    model = sharding.distribute_params(
        copy.deepcopy(base), build_mesh({"data": 1, "model": tp}),
        sharding.DECODER_TP_RULES)
    seq = np.random.RandomState(1).randint(
        0, c["vocab"], (c["batch"], c["prompt"] + 1))
    got = decode_step_traffic(model, seq, device=dev)
    want = megatron_decode_bytes(c["layers"], c["batch"], c["hidden"])
    return {"model": {k: c[k] for k in ("hidden", "heads", "layers")},
            "batch": c["batch"],
            "local_heads": c["heads"] // sharding.head_shards(
                model.blocks[0].attn).tp,
            "collectives": got["families"],
            "bytes_per_token": got["bytes"],
            "megatron_bytes_per_token": want,
            "matches_megatron": got["bytes"] == want}


def measure(tp, device=None):
    """The report of one width, on this process group's ``tp`` ranks
    (``torch.distributed`` initialized, world size ``tp``), on
    ``device`` (None: this rank's card)."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import device_info

    if dist.get_world_size() != tp:
        raise ValueError("measure({}) needs a group of {} ranks, this one "
                         "has {}".format(tp, tp, dist.get_world_size()))
    dev = device_info.default_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    report = _bert_step(tp, dev)
    report["decode"] = _decode_row(tp, dev)
    return report


def _rank_main(rank, tp, port, out, device_type):
    """One rank of a width's group — NCCL on card ``rank`` for
    ``"cuda"``, gloo for ``"cpu"`` — runs :func:`measure`; rank 0
    writes the report to ``out``."""
    import datetime

    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend, dev = "nccl", torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        backend, dev = "gloo", torch.device("cpu")
    dist.init_process_group(
        backend, init_method="tcp://127.0.0.1:{}".format(port),
        world_size=tp, rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        report = measure(tp, dev)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(report, f)


def ranks_of(device=None):
    """How a width's ranks run for ``device`` (None: the cards; a card
    must be present): ``"cuda"`` (NCCL, one rank a card) or ``"cpu"``
    (gloo ranks on the CPU)."""
    from tensorflowonspark_tpu_torch import device_info

    return device_info.default_device(device).type


def run_width(tp, device=None, timeout=RANK_TIMEOUT):
    """:func:`measure` in a fresh group of ``tp`` spawned ranks on
    ``device`` (None: one card a rank, NCCL; ``"cpu"``: gloo ranks).
    Raises when ``tp`` is below 2 or exceeds the cards torch sees.
    Returns the report, or ``{"tp": tp, "error": ...}`` when a rank
    fails or the group outlives ``timeout`` seconds (its ranks are then
    killed)."""
    import torch
    import torch.multiprocessing as mp

    from tensorflowonspark_tpu_torch import util

    if tp < 2:
        raise ValueError("a TP width is 2 or more, got {}".format(tp))
    kind = ranks_of(device)
    if kind == "cuda" and torch.cuda.device_count() < tp:
        raise RuntimeError(
            "tp {} needs {} cards (one NCCL rank a card), torch sees {}; "
            "pass device='cpu' (--device cpu) for gloo ranks on the "
            "CPU".format(tp, tp, torch.cuda.device_count()))
    fd, out = tempfile.mkstemp(prefix="tp-scaling-", suffix=".json")
    os.close(fd)
    # by reference, so the ranks import it under its package name
    from tensorflowonspark_tpu_torch import tp_scaling_model as me

    try:
        ctx = mp.start_processes(
            me._rank_main, args=(tp, util.find_free_port(), out, kind),
            nprocs=tp, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    return {"tp": tp, "error": "timed out after {} s"
                            .format(timeout)}
        except Exception as e:  # noqa: BLE001 - a bad width is a record
            return {"tp": tp, "error": str(e)[-400:]}
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        with open(out) as f:
            return json.load(f)
    finally:
        os.unlink(out)


def _ranks_note(kind):
    if kind == "cpu":
        return "gloo ranks on the CPU"
    from tensorflowonspark_tpu_torch import device_info

    return "NCCL ranks, one a card: " + "; ".join(
        device_info.describe().splitlines())


def _ok(point):
    return "error" not in point and point["step_executed"] \
        and point["decode"]["matches_megatron"]


def sweep(tps, device=None):
    """One fresh group per width on ``device`` (as :func:`run_width`);
    ``all_points_ok`` when every width ran its step and its decode row
    matched the megatron count."""
    points = [run_width(tp, device) for tp in tps]
    return {"sweep": points,
            "all_points_ok": bool(points) and all(_ok(p) for p in points),
            "note": "payload bytes counted per collective family in one "
                    "step on {}; no interconnect rate is assumed".format(
                        _ranks_note(ranks_of(device)))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tp", type=int, default=2,
                    help="one width (default 2)")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated widths, e.g. 2,4")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the ranks run: the cards (default; NCCL, "
                         "one rank a card) or the CPU (gloo)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.sweep:
        report = sweep([int(s) for s in args.sweep.split(",")],
                       args.device)
        ok = report["all_points_ok"]
    else:
        report = run_width(args.tp, args.device)
        report["ranks"] = _ranks_note(ranks_of(args.device))
        ok = _ok(report)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

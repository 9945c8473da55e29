"""Data parallelism in the port's ``Trainer`` (DDP over a gloo group on
the CPU) against the JAX ``Trainer`` on the whole global batch.

- Two trainers through the port's ``cluster.run`` (``InputMode.TENSORFLOW``,
  ``TFOS_TPU_DISTRIBUTED=1``), each stepping on its half of a seeded
  global batch, from the same converted weights. Both ranks report the
  same loss each step (the all-reduced global mean), their parameters
  end bitwise equal, and both run wrapped in ``DistributedDataParallel``.
  Against the JAX ``Trainer`` stepping on the whole global batch in one
  process: losses within 1e-5 relative and final parameters within 1e-5
  absolute (float32: the mean over two halves and the mean over the
  whole differ in summation order only). Adam divides each gradient by
  its own running magnitude, so where a gradient is rounding noise in
  exact arithmetic the two packages step by up to one learning rate in
  different directions: the attention key bias (it shifts every logit
  of a row alike, so its gradient is zero) and, in this run, one element
  of 4096 in ``blocks.1.mlp_in.weight`` (1.3e-5 off, the same in a
  one-process port run). There the bound is one learning rate per step,
  for all of the key bias and for at most 1 element in 1000 elsewhere.
  ``train_loop`` counts global examples. One process with no group
  takes no DDP.
- The card each rank takes (``node.local_device_index``): one host, two
  hosts, more ranks than cards, a lone rank, a host of its own.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from tensorflowonspark_tpu import training as jtraining
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import cluster, convert, node
from tensorflowonspark_tpu_torch.engine import Context

CFG = {"vocab": 64, "hidden": 32, "num_heads": 4, "num_layers": 2,
       "max_len": 128}
LR, GLOBAL_BATCH, STEPS = 1e-3, 4, 3
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
#: a zero-gradient parameter moves by at most ~one learning rate a step
NOISE_PARAM_TOL = STEPS * LR


def _global_batches():
    rng = np.random.RandomState(11)
    rows = rng.randint(0, CFG["vocab"],
                       (STEPS, GLOBAL_BATCH, CFG["max_len"] + 1))
    return [{"x": r[:, :-1], "y": r[:, 1:]} for r in rows]


def test_two_rank_ddp_matches_reference_global_batch(tmp_path):
    batches = _global_batches()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = jtraining.Trainer(JaxLM(**CFG), optax.adamw(LR), mesh,
                           loss_fn=jtraining.softmax_xent)
    jstate = jt.init(jax.random.PRNGKey(4),
                     jnp.asarray(batches[0]["x"], jnp.int32))
    weights = convert.from_flax(jax.tree.map(np.asarray, jstate["params"]))
    wpath = str(tmp_path / "weights.npz")
    np.savez(wpath, **{k: v.numpy() for k, v in weights.items()})
    want = []
    for b in batches:
        jstate, m = jt.step(jstate, {k: v.astype(np.int32)
                                     for k, v in b.items()})
        want.append(float(m["loss"]))
    want_params = convert.from_flax(jax.tree.map(np.asarray,
                                                 jstate["params"]))
    bpath = str(tmp_path / "batches.npz")
    np.savez(bpath, x=np.stack([b["x"] for b in batches]),
             y=np.stack([b["y"] for b in batches]))
    out = str(tmp_path / "out")
    os.makedirs(out)

    def map_fun(args, ctx):
        import numpy as np
        import torch
        import torch.distributed as dist
        from tensorflowonspark_tpu_torch import training
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        dev = ctx.initialize_torch("cpu")
        rank, world = dist.get_rank(), dist.get_world_size()
        model = DecoderLM(**args["cfg"])
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               np.load(args["weights"]).items()})
        tr = training.Trainer(model, training.adamw(args["lr"]), device=dev)
        state = tr.init()
        data = np.load(args["batches"])
        half = data["x"].shape[1] // world
        local = [{"x": data["x"][i, rank * half:(rank + 1) * half],
                  "y": data["y"][i, rank * half:(rank + 1) * half]}
                 for i in range(data["x"].shape[0])]
        # a clock that advances one second a call: train_loop reads it
        # at its start and its end, so its rate is its example count
        ticks = iter(range(10 ** 6))
        training.time = type("Clock", (), {
            "monotonic": staticmethod(lambda: float(next(ticks)))})
        losses = []
        state, steps, rate = tr.train_loop(
            state, iter(local), log_every=0, ledger=False,
            hooks=(lambda n, s, m: losses.append(m["loss"].item()),))
        np.savez("{}/params{}.npz".format(args["out"], rank),
                 **{k: v.detach().numpy()
                    for k, v in model.state_dict().items()})
        with open("{}/r{}.json".format(args["out"], rank), "w") as f:
            json.dump({"losses": losses, "steps": steps, "world": world,
                       "examples": rate,
                       "ddp": isinstance(
                           tr.net, torch.nn.parallel.DistributedDataParallel),
                       "params_unwrapped": all(
                           p is dict(model.named_parameters())[n]
                           for n, p in state["params"].items()),
                       "local_batch": half}, f)
        dist.destroy_process_group()

    sc = Context(num_executors=2, work_root=str(tmp_path / "engine"),
                 executor_env={"TFOS_TPU_DISTRIBUTED": "1"})
    try:
        tfc = cluster.run(sc, map_fun, {"cfg": CFG, "lr": LR,
                                        "weights": wpath, "batches": bpath,
                                        "out": out}, 2,
                          input_mode=cluster.InputMode.TENSORFLOW,
                          reservation_timeout=300)
        tfc.shutdown(timeout=600)
    finally:
        sc.stop()
    ranks = [json.load(open(os.path.join(out, "r%d.json" % r)))
             for r in range(2)]
    params = [dict(np.load(os.path.join(out, "params%d.npz" % r)))
              for r in range(2)]
    assert all(r["ddp"] and r["params_unwrapped"] and r["world"] == 2
               and r["steps"] == STEPS and r["local_batch"] == 2
               and r["examples"] == GLOBAL_BATCH * STEPS
               for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for k in params[0]:
        np.testing.assert_array_equal(params[0][k], params[1][k])
    for g, w in zip(ranks[0]["losses"], want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (ranks[0]["losses"], want)
    assert set(params[0]) == set(want_params)
    for k, w in want_params.items():
        err = np.abs(params[0][k] - w.numpy())
        assert err.max() <= NOISE_PARAM_TOL, (k, err.max())
        if not k.endswith("attn.key.bias"):
            assert (err > PARAM_TOL).sum() <= max(1, err.size // 1000), (
                k, np.sort(err.ravel())[-3:])


def test_one_process_trainer_takes_no_ddp():
    import torch

    from tensorflowonspark_tpu_torch import training
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    with pytest.raises(RuntimeError, match="before Trainer.init"):
        training.Trainer(DecoderLM(**CFG), training.adamw(LR),
                         device="cpu").step({}, {})
    tr = training.Trainer(DecoderLM(**CFG), training.adamw(LR),
                          device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    assert tr.world_size == 1 and tr.net is tr.model


def _nodes(*hosts):
    return [{"executor_id": i, "host": h} for i, h in enumerate(hosts)]


@pytest.mark.parametrize("hosts,visible,want", [
    (("a", "a"), 2, [0, 1]),                      # one host, a card each
    (("a", "b"), 1, [0, 0]),                      # two hosts of one card
    (("a", "a", "b", "b"), 2, [0, 1, 0, 1]),      # two hosts of two
    (("a", "a", "a"), 2, [0, 1, 0]),              # more ranks than cards
    (("a",), 4, [0]),                             # a lone rank
    (("a", "b", "a", "b", "a"), 8, [0, 0, 1, 1, 2]),  # interleaved hosts
], ids=["one-host", "two-hosts-one-card", "two-hosts-two-cards",
        "more-ranks-than-cards", "lone-rank", "interleaved"])
def test_local_device_index(hosts, visible, want):
    nodes = _nodes(*hosts)
    assert [node.local_device_index(nodes, n["executor_id"], visible)
            for n in nodes] == want


def test_local_device_index_refuses_strangers():
    with pytest.raises(ValueError, match="not among"):
        node.local_device_index(_nodes("a"), 5, 1)
    with pytest.raises(ValueError, match="no visible card"):
        node.local_device_index(_nodes("a"), 0, 0)


def test_initialize_torch_explicit_device_wins_and_no_card_raises():
    import torch

    ctx = node.NodeContext(1, "worker", 0, _nodes("a", "a"),
                           {"id": "x"})
    assert ctx.initialize_torch("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctx.initialize_torch()

"""Cluster-level checkpoint/resume on the port: the reference's recovery
story (``tests/test_resume.py``) through the port's ``cluster.run``,
trainer processes and ``Checkpointer``.

- ``test_cluster_resume_from_checkpoint`` is the reference's own case,
  rebound: its ``_run_twice`` (train-save in one cluster, then
  restore-train in a fresh one) drives the port's ``Context`` and
  ``cluster``, with the reference's LeNet map_fun in the port's terms
  (``models.lenet.LeNet``, SGD 0.01, the same synthetic batch).
- The tensor-parallel case keeps the reference's contract (start 0 ->
  3, then 3 -> 6, the loss still falling, the restored parameters back
  in their TP layout) on the port's terms: a mesh axis spans ranks
  here, so the ``model`` axis is two trainer processes in one gloo
  group, where the reference shards over a one-process device mesh.
"""

import json
import os

import test_torch_fleet
from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context

REF, PORT = test_torch_fleet.port_namespace(
    "test_resume.py", port_imports=True, cluster=cluster, Context=Context)


def _lenet_map_fun():
    """The reference's ``_train_fun`` in the port's terms (built in a
    function so it ships by value)."""

    def train_fun(args, ctx):
        import numpy as np
        import torch

        from tensorflowonspark_tpu_torch import checkpoint, training
        from tensorflowonspark_tpu_torch.models.lenet import LeNet

        dev = ctx.initialize_torch("cpu")
        trainer = training.Trainer(
            LeNet(num_classes=10),
            lambda params: torch.optim.SGD(params, lr=0.01), device=dev)
        rng = np.random.RandomState(0)
        x = rng.rand(16, 28, 28, 1).astype(np.float32)
        y = (np.arange(16) % 10).astype(np.int64)
        state = trainer.init(torch.Generator().manual_seed(0))

        ckpt = checkpoint.Checkpointer(args["dir"],
                                       chief=ctx.job_name == "chief")
        restored = ckpt.restore(state)
        start_step = 0 if restored is None else int(restored["step"])
        if restored is not None:
            state = restored
        for _ in range(args["steps"]):
            state, metrics = trainer.step(state, {"x": x, "y": y})
        ckpt.save(int(state["step"]), state, force=True)
        ckpt.wait()
        ckpt.close()
        with open(os.path.join(args["dir"], "run-%d.json" % args["run"]),
                  "w") as f:
            json.dump({"start_step": start_step,
                       "end_step": int(state["step"]),
                       "loss": float(metrics["loss"])}, f)

    return train_fun


def test_cluster_resume_from_checkpoint(tmp_path):
    PORT["_train_fun"] = _lenet_map_fun()
    PORT["test_cluster_resume_from_checkpoint"](tmp_path)


def _tp_map_fun():
    """Two ranks, mesh ``{data: 1, model: 2}``: an MLP whose ``up``
    weight is sharded on its output rows and ``down`` on its input
    columns (the reference's ``up/kernel P(None, "model")``,
    ``down/kernel P("model", None)`` for torch's [out, in] layout)."""

    def train_fun(args, ctx):
        import numpy as np
        import torch
        import torch.distributed as dist
        import torch.nn as nn
        from torch.distributed.tensor import Replicate, Shard

        from tensorflowonspark_tpu_torch import checkpoint, training
        from tensorflowonspark_tpu_torch.parallel import sharding

        class MLP(nn.Module):
            def __init__(self):
                super(MLP, self).__init__()
                self.up = nn.Linear(12, 16)
                self.down = nn.Linear(16, 8)

            def forward(self, x):
                return self.down(torch.relu(self.up(x)))

        dev = ctx.initialize_torch("cpu")
        mesh = ctx.mesh({"data": 1, "model": 2})
        rules = ((r"up\.weight", ("model", None)),
                 (r"down\.weight", (None, "model")))
        torch.manual_seed(0)
        model = sharding.distribute_params(MLP(), mesh, rules)
        trainer = training.Trainer(
            model, lambda params: torch.optim.SGD(params, lr=0.05),
            mesh=mesh, device=dev)
        rng = np.random.RandomState(0)
        x = rng.rand(16, 12).astype(np.float32)
        y = (np.arange(16) % 8).astype(np.int64)
        state = trainer.init()

        ckpt = checkpoint.Checkpointer(args["dir"],
                                       chief=ctx.job_name == "chief")
        restored = ckpt.restore(state)
        start_step = 0 if restored is None else int(restored["step"])
        if restored is not None:
            state = restored
            # the restore must come back in the TP layout state carries
            up = state["params"]["up.weight"]
            assert list(up.placements) == [Replicate(), Shard(0)], \
                up.placements
        for _ in range(args["steps"]):
            state, metrics = trainer.step(state, {"x": x, "y": y})
        ckpt.save(int(state["step"]), state, force=True)
        if dist.get_rank() == 0:
            with open(os.path.join(args["dir"],
                                   "tp-run-%d.json" % args["run"]),
                      "w") as f:
                json.dump({"start_step": start_step,
                           "end_step": int(state["step"]),
                           "loss": float(metrics["loss"]),
                           "up_placements": [str(p) for p in state[
                               "params"]["up.weight"].placements]}, f)
        dist.destroy_process_group()

    return train_fun


def test_cluster_resume_tp_sharded_state(tmp_path):
    """Resubmit-and-restore with a TENSOR-PARALLEL state: the checkpoint
    round-trips through fresh cluster processes with the sharded layout
    preserved, and training continues."""
    ckpt_dir = str(tmp_path / "tp-ckpt")
    os.makedirs(ckpt_dir)
    for run in (1, 2):
        sc = Context(num_executors=2,
                     work_root=str(tmp_path / ("tp-engine%d" % run)),
                     executor_env={"TFOS_TPU_DISTRIBUTED": "1"})
        try:
            tfc = cluster.run(sc, _tp_map_fun(),
                              {"dir": ckpt_dir, "steps": 3, "run": run},
                              num_executors=2,
                              input_mode=cluster.InputMode.TENSORFLOW,
                              reservation_timeout=300)
            tfc.shutdown(timeout=600)
        finally:
            sc.stop()
    r1, r2 = (json.load(open(os.path.join(ckpt_dir, "tp-run-%d.json" % n)))
              for n in (1, 2))
    assert r1["start_step"] == 0 and r1["end_step"] == 3
    assert r2["start_step"] == 3 and r2["end_step"] == 6
    assert r2["loss"] < r1["loss"]  # training actually continued
    assert r1["up_placements"] == r2["up_placements"] == ["R", "S(0)"]

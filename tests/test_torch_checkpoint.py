"""The port's ``checkpoint`` (``torch.distributed.checkpoint``) against
the reference's contract.

- A save/restore round trip returns the parameters, the AdamW moments
  and step counts, and ``state["step"]`` bitwise (``torch.equal``).
- Resume: 3 steps, save, a fresh model and ``Trainer`` from another
  seed, restore, 3 more steps gives the losses of 6 uninterrupted steps
  bitwise on the CPU, and the JAX ``Trainer``'s 6 losses from the same
  weights within 1e-5 relative (float32; the two differ in summation
  order only).
- The reference's ``save`` contract: ``chief=False`` without a process
  group is a no-op, an already persisted step is a no-op (decided from
  the construction-time snapshot plus this instance's saves), a remote
  root is refused unless ``allow_remote`` (then DCP's fsspec storage
  serves it), ``max_to_keep`` retention, a step directory is whole or
  absent.
- ``restore(fallback=True)`` walks back past a step corrupted by the
  ``corrupt_checkpoint`` chaos point; without ``fallback`` it raises.
- ``hook``'s cadence, and the goodput ledger's ``checkpoint_save`` and
  ``restore`` categories.
- Two ranks in one gloo group save through the cluster (DCP's collective
  path) and restore into fresh models, bitwise.
- The sharded-state protocol on plain tensors: ``is_fully_replicated``
  and ``respec_like`` agree with the reference's on host arrays (a
  DTensor state saved at 2 ranks and restored at 1 is held in
  ``tests/test_torch_parallel.py``).
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from torch.distributed.checkpoint.api import CheckpointException

from tensorflowonspark_tpu import training as jtraining
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import (chaos, checkpoint, convert, fs,
                                         goodput, training)
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

V, H, NH, L, T = 64, 32, 4, 2, 128
LR = 1e-3
#: port vs JAX losses over 6 steps, relative (float32, summation order)
LOSS_RTOL = 1e-5


def _batches(n=6, b=2, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        row = rng.randint(0, V, (b, T + 1)).astype(np.int64)
        out.append({"x": row[:, :-1], "y": row[:, 1:]})
    return out


def _trainer(seed):
    model = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    tr = training.Trainer(model, training.adamw(LR), device="cpu")
    return tr, tr.init(torch.Generator().manual_seed(seed))


def _snapshot(state):
    """Every tensor of the state, cloned: parameters and the optimizer's
    per-parameter state keyed by parameter name."""
    names = {id(p): n for n, p in state["params"].items()}
    out = {"p/" + n: p.detach().clone() for n, p in state["params"].items()}
    opt = state["opt_state"]
    for p, st in opt.state.items():
        for k, v in st.items():
            out["o/{}/{}".format(names[id(p)], k)] = v.clone()
    return out, state["step"]


def _assert_bitwise(a, b):
    (ta, sa), (tb, sb) = a, b
    assert sa == sb
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_save_restore_bitwise(tmp_path):
    tr, state = _trainer(0)
    for batch in _batches(3):
        state, _ = tr.step(state, batch)
    saved = _snapshot(state)
    assert saved[1] == 3 and len(saved[0]) == 4 * len(state["params"])
    ckpt = checkpoint.Checkpointer(str(tmp_path / "ck"))
    assert ckpt.save(3, state) is True
    assert ckpt.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ck")) == ["3"]
    assert ".metadata" in os.listdir(tmp_path / "ck" / "3")

    tr2, fresh = _trainer(99)
    assert not torch.equal(fresh["params"]["head.weight"],
                           state["params"]["head.weight"])
    restored = ckpt.restore(fresh)
    assert restored is fresh
    _assert_bitwise(_snapshot(restored), saved)
    assert checkpoint.Checkpointer(str(tmp_path / "empty")).restore(
        fresh) is None
    with pytest.raises(TypeError, match="TrainState"):
        ckpt.save(4, dict(state))


def test_resume_matches_uninterrupted_and_reference(tmp_path):
    batches = _batches(6)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = jtraining.Trainer(
        JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T),
        optax.adamw(LR), mesh, loss_fn=jtraining.softmax_xent)
    jstate = jt.init(jax.random.PRNGKey(0), batches[0]["x"].astype(np.int32))
    weights = convert.from_flax(jax.tree.map(np.asarray, jstate["params"]))
    want = []
    for b in batches:
        jstate, m = jt.step(jstate, {k: v.astype(np.int32)
                                     for k, v in b.items()})
        want.append(float(m["loss"]))

    def fresh(seed=None):
        model = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L,
                          max_len=T)
        model.load_state_dict(weights)
        tr = training.Trainer(model, training.adamw(LR), device="cpu")
        return tr, tr.init(None if seed is None
                           else torch.Generator().manual_seed(seed))

    tr, state = fresh()
    straight = []
    for b in batches:
        state, m = tr.step(state, b)
        straight.append(m["loss"].item())

    tr, state = fresh()
    ckpt = checkpoint.Checkpointer(str(tmp_path / "ck"))
    resumed = []
    state, _, _ = tr.train_loop(
        state, iter(batches[:3]), log_every=0, ledger=False,
        hooks=(lambda n, s, m: resumed.append(m["loss"].item()),
               checkpoint.hook(ckpt, every_steps=3)))
    assert ckpt.latest_step() == 3
    del tr, state
    tr, state = fresh(seed=7)  # other weights: the restore must win
    state = ckpt.restore(state, step=3)
    assert state["step"] == 3
    for b in batches[3:]:
        state, m = tr.step(state, b)
        resumed.append(m["loss"].item())
    assert resumed == straight  # bitwise on the CPU
    for g, w in zip(resumed, want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (resumed, want)


def test_save_contract(tmp_path):
    tr, state = _trainer(0)
    root = str(tmp_path / "ck")
    assert checkpoint.Checkpointer(root, chief=False).save(1, state) is False
    assert not os.listdir(root)
    ckpt = checkpoint.Checkpointer(root)
    assert ckpt.save(1, state) is True
    assert ckpt.save(1, state) is False  # saved through this instance
    again = checkpoint.Checkpointer(root)
    assert again.save(1, state) is False  # on disk at construction
    assert again.all_steps() == [1]
    assert not [n for n in os.listdir(root) if n.startswith(".tmp-")]
    # the skip decision is never a live scan: a step that lands after
    # construction is not "persisted" for this instance
    late = checkpoint.Checkpointer(root)
    other = checkpoint.Checkpointer(root)
    assert other.save(2, state) is True
    with pytest.raises(OSError):
        late.save(2, state)
    # the reference's signature: force is accepted
    assert ckpt.save(3, state, force=True) is True


def test_remote_root_refused_unless_allowed(tmp_path):
    tr, state = _trainer(0)
    with pytest.raises(fs.UnsupportedSchemeError):
        checkpoint.Checkpointer("hdfs://nn/ckpt")
    root = "memory://tfos-ckpt-{}".format(os.getpid())
    ckpt = checkpoint.Checkpointer(root, allow_remote=True, max_to_keep=1)
    assert ckpt.save(1, state)
    state, _ = tr.step(state, _batches(1)[0])
    saved = _snapshot(state)
    assert ckpt.save(2, state)
    assert ckpt.all_steps() == [2]
    tr2, fresh = _trainer(5)
    _assert_bitwise(_snapshot(ckpt.restore(fresh)), saved)


def test_max_to_keep(tmp_path):
    tr, state = _trainer(0)
    ckpt = checkpoint.Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, state)
    assert ckpt.all_steps() == [3, 4]
    keep_all = checkpoint.Checkpointer(str(tmp_path / "all"),
                                       max_to_keep=None)
    for s in (1, 2, 3, 4):
        keep_all.save(s, state)
    assert keep_all.all_steps() == [1, 2, 3, 4]


def test_restore_fallback_past_corrupt_step(tmp_path):
    tr, state = _trainer(0)
    batches = _batches(2)
    root = str(tmp_path / "ck")
    ckpt = checkpoint.Checkpointer(root)
    chaos.arm("corrupt_checkpoint=2")
    try:
        state, _ = tr.step(state, batches[0])
        ckpt.save(1, state)
        good = _snapshot(state)
        state, _ = tr.step(state, batches[1])
        ckpt.save(2, state)
    finally:
        chaos.disarm()
    assert ckpt.latest_step() == 2
    tr2, fresh = _trainer(3)
    with pytest.raises(CheckpointException, match="metadata"):
        ckpt.restore(fresh)
    tr3, fresh = _trainer(3)
    _assert_bitwise(_snapshot(ckpt.restore(fresh, fallback=True)), good)
    assert chaos.corrupt_step(root, 1) == 2  # .metadata and one shard
    with pytest.raises(RuntimeError, match="could be restored"):
        ckpt.restore(_trainer(4)[1], fallback=True)


def test_hook_cadence_and_goodput(tmp_path):
    goodput.reset()
    try:
        tr, state = _trainer(0)
        ckpt = checkpoint.Checkpointer(str(tmp_path / "ck"),
                                       max_to_keep=None)
        tr.train_loop(state, iter(_batches(5)), log_every=0, ledger=False,
                      hooks=(checkpoint.hook(ckpt, every_steps=2),))
        assert ckpt.all_steps() == [2, 4]
        ckpt.wait()
        ckpt.restore(_trainer(1)[1])
        rep = goodput.ledger().report()
        assert rep["badput"]["checkpoint_save"] > 0
        assert rep["badput"]["restore"] > 0
        ckpt.close()
    finally:
        goodput.reset()


def test_two_rank_gloo_save_and_restore(tmp_path):
    """Two trainers in one gloo group: both call save (DCP's collective;
    each replicated tensor written once), then both restore into fresh
    models from another seed, bitwise equal to what they saved."""
    from tensorflowonspark_tpu_torch import cluster
    from tensorflowonspark_tpu_torch.engine import Context

    root, out = str(tmp_path / "ck"), str(tmp_path / "out")
    os.makedirs(out)

    def map_fun(args, ctx):
        import hashlib

        import numpy as np
        import torch
        import torch.distributed as dist
        from tensorflowonspark_tpu_torch import checkpoint, training
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        dev = ctx.initialize_torch("cpu")
        rank = dist.get_rank()

        def make(seed):
            model = DecoderLM(64, hidden=32, num_heads=4, num_layers=2,
                              max_len=128)
            tr = training.Trainer(model, training.adamw(1e-3), device=dev)
            return tr, tr.init(torch.Generator().manual_seed(seed))

        def digest(state):
            h = hashlib.sha256()
            for n, p in sorted(state["params"].items()):
                h.update(p.detach().numpy().tobytes())
            for st in state["opt_state"].state.values():
                for k in sorted(st):
                    h.update(st[k].numpy().tobytes())
            return h.hexdigest()

        tr, state = make(0)
        rng = np.random.RandomState(rank)
        for _ in range(2):
            row = rng.randint(0, 64, (2, 129))
            state, _ = tr.step(state, {"x": row[:, :-1], "y": row[:, 1:]})
        ckpt = checkpoint.Checkpointer(args["root"], chief=(rank == 0))
        saved = ckpt.save(2, state)
        want = digest(state)
        tr2, fresh = make(50 + rank)
        before = digest(fresh)
        fresh = ckpt.restore(fresh)
        with open("{}/r{}.json".format(args["out"], rank), "w") as f:
            json.dump({"saved": saved, "want": want, "got": digest(fresh),
                       "before": before, "step": fresh["step"],
                       "files": sorted(os.listdir(args["root"] + "/2"))}, f)
        dist.destroy_process_group()

    sc = Context(num_executors=2, work_root=str(tmp_path / "engine"),
                 executor_env={"TFOS_TPU_DISTRIBUTED": "1"})
    try:
        tfc = cluster.run(sc, map_fun, {"root": root, "out": out}, 2,
                          input_mode=cluster.InputMode.TENSORFLOW,
                          reservation_timeout=300)
        tfc.shutdown(timeout=600)
    finally:
        sc.stop()
    got = [json.load(open(os.path.join(out, "r%d.json" % r)))
           for r in range(2)]
    assert all(g["saved"] is True and g["step"] == 2 for g in got)
    # DDP keeps the ranks in lockstep: one state, saved once
    assert got[0]["want"] == got[1]["want"]
    assert all(g["got"] == g["want"] != g["before"] for g in got)
    assert ".metadata" in got[0]["files"]
    assert os.listdir(root) == ["2"]


def test_replication_protocol_on_plain_state():
    """Plain tensors count as replicated, as the reference's host arrays
    do; ``respec_like`` passes them through unchanged (a TrainState's
    module keeps its parameters, its optimizer its moments)."""
    from tensorflowonspark_tpu import checkpoint as jcheckpoint

    tree = {"a": np.ones(3, np.float32), "b": [np.zeros(2), 3]}
    assert jcheckpoint.is_fully_replicated(tree)
    ttree = {"a": torch.ones(3), "b": [torch.zeros(2), 3]}
    assert checkpoint.is_fully_replicated(ttree)
    got = checkpoint.respec_like(ttree, mesh=None)
    assert got["a"] is ttree["a"] and got["b"][0] is ttree["b"][0]
    assert got["b"][1] == 3
    tr, state = _trainer(0)
    state, _ = tr.step(state, _batches(1)[0])
    assert checkpoint.is_fully_replicated(state)
    before = _snapshot(state)
    assert checkpoint.respec_like(state, mesh=None) is state
    _assert_bitwise(_snapshot(state), before)

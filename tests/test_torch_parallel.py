"""The port's ``parallel`` package (``tensorflowonspark_tpu_torch
.parallel``) against the JAX package's ``tests/test_parallel.py`` cases.

Pure functions (the mesh arithmetic, the TP catalogs) are held in
process. Everything that needs ranks runs in two spawns of gloo ranks on
the CPU — one of 2 ranks and one of 4 — each making several checks, and
writing its numbers to ``tmp_path`` for the parent, which holds them
against the JAX package's functions on the virtual CPU devices (no
``XLA_FLAGS`` is needed on the torch side). Inputs come from numpy
seeds. Tolerances are stated at each check.
"""

import datetime
import functools
import json
import os
import re
import time
import types

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.parallel import mesh as tmesh
from tensorflowonspark_tpu_torch.parallel import sharding

#: a spawn's ranks must finish within this (each pays torch's import)
SPAWN_TIMEOUT = 240


# -- the spawn harness ----------------------------------------------------


def _init(rank, world, port):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:{}".format(port),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=120))


def _spawn(fn, world, out_dir, *args):
    """Run ``fn(rank, world, port, out_dir, *args)`` in ``world`` spawned
    ranks; raises with a rank's traceback if one fails, and kills them
    all past :data:`SPAWN_TIMEOUT`. Returns each rank's saved dict."""
    import torch.multiprocessing as mp

    from tensorflowonspark_tpu_torch import util

    port = util.find_free_port()
    ctx = mp.start_processes(fn, args=(world, port, str(out_dir)) + args,
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError("gloo ranks still running after "
                                   "{} s".format(SPAWN_TIMEOUT))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(str(out_dir), "rank{}.pt".format(r)),
                       weights_only=False) for r in range(world)]


def _save(out_dir, rank, result):
    torch.save(result, os.path.join(out_dir, "rank{}.pt".format(rank)))


def _ring_vs_lockstep(rank, world):
    """The P2P ring over the ``seq`` group against the lockstep on the
    same global inputs: local out and q/k/v gradients, for each schedule.
    Returns the worst |P2P - lockstep| per schedule."""
    from tensorflowonspark_tpu_torch.parallel import build_mesh
    from tensorflowonspark_tpu_torch.parallel import ring_attention as ra

    mesh = build_mesh({"seq": world})
    rng = np.random.RandomState(11)
    s = 16 * world
    glob = [torch.tensor(rng.randn(2, s, 2, 16).astype(np.float32))
            for _ in range(4)]
    worst = {}
    for name, causal, layout, variant in (
            ("flash", False, "contiguous", "flash"),
            ("flash_causal", True, "contiguous", "flash"),
            ("zigzag", True, "zigzag", "flash"),
            ("online_causal", True, "contiguous", "online")):
        q, k, v, w = (t.clone().requires_grad_(i < 3)
                      for i, t in enumerate(glob))
        if layout == "zigzag":
            q, k, v, w = (ra.to_zigzag(t, world) for t in (q, k, v, w))
        kw = {"causal": causal}
        if variant == "flash":
            kw.update(block_q=8, block_k=8, layout=layout)
        want = ra._ring_lockstep(q, k, v, world, variant=variant, **kw)
        gq, gk, gv = torch.autograd.grad((want * w).sum(), (q, k, v))
        ql, kl, vl = (t.detach().chunk(world, dim=1)[rank].clone()
                      .requires_grad_() for t in (q, k, v))
        wl = w.chunk(world, dim=1)[rank]
        fn = (ra.ring_flash_attention if variant == "flash"
              else ra.ring_attention)
        got = fn(ql, kl, vl, mesh, **kw)
        (got * wl).sum().backward()
        pairs = [(got.detach(), want.detach().chunk(world, dim=1)[rank])]
        pairs += [(t.grad, g.chunk(world, dim=1)[rank])
                  for t, g in zip((ql, kl, vl), (gq, gk, gv))]
        worst[name] = max((a - b).abs().max().item() for a, b in pairs)
    return worst


# -- the 2-rank spawn -----------------------------------------------------


def _widedeep(dtype=torch.float32):
    from tensorflowonspark_tpu_torch.models.widedeep import WideDeep

    model = WideDeep(num_dense=4, num_cat=6, hash_buckets=64, embed_dim=8,
                     mlp_sizes=(16, 16), dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _ctr_batch(data_rank, step):
    rng = np.random.RandomState(100 * data_rank + step)
    b = 8
    return {"dense": rng.rand(b, 4).astype(np.float32),
            "cat": rng.randint(0, 64, size=(b, 6)).astype(np.int64),
            "label": (rng.rand(b) > 0.5).astype(np.float32)}


def _train_losses(trainer, state, data_rank, steps=3):
    losses = []
    for i in range(steps):
        state, m = trainer.step(state, _ctr_batch(data_rank, i))
        losses.append(float(m["loss"]))
    return state, losses


def _worker_two(rank, world, port, out_dir, ckpt_dir):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from tensorflowonspark_tpu_torch import checkpoint, training
    from tensorflowonspark_tpu_torch.models.widedeep import ctr_loss
    from tensorflowonspark_tpu_torch.parallel import (
        build_hybrid_mesh, build_mesh)

    _init(rank, world, port)
    res = {"ring": _ring_vs_lockstep(rank, world)}

    # the DDP path on a pure data mesh: the reference's losses for the
    # 4-rank TP trainer below
    mesh = build_mesh({"data": 2})
    trainer = training.Trainer(_widedeep(), training.adamw(0.05),
                               loss_fn=ctr_loss,
                               input_keys=("dense", "cat"), device="cpu",
                               mesh=mesh)
    state = trainer.init()
    res["ddp_uses_ddp"] = isinstance(
        trainer.net, torch.nn.parallel.DistributedDataParallel)
    _, res["ddp_losses"] = _train_losses(trainer, state, rank)

    # hybrid meshes over the hosts gathered from the ranks (one host, so
    # the layout is the contiguous reshape): the DCN axis inferred and
    # outer, or the ICI axis inferred and spanning the host
    hm = build_hybrid_mesh({"data": -1}, {"model": 1})
    res["hybrid"] = (hm.mesh_dim_names, tuple(hm.shape),
                     hm.mesh.tolist())
    hm = build_hybrid_mesh({"data": 1}, {"model": -1})
    res["hybrid_gathered"] = (tuple(hm.shape), hm.mesh.tolist())

    # a row-sharded state saved at 2 ranks ...
    mesh = build_mesh({"model": 2})
    model = sharding.distribute_params(_widedeep(), mesh,
                                       sharding.WIDEDEEP_TP_RULES)
    trainer = training.Trainer(model, training.adamw(0.05),
                               loss_fn=ctr_loss, input_keys=("dense", "cat"),
                               device="cpu", mesh=mesh)
    state = trainer.init()
    state, _ = _train_losses(trainer, state, 0, steps=1)
    res["sharded_replicated"] = checkpoint.is_fully_replicated(state)
    res["table_placements"] = tuple(
        model.deep_embeddings.weight.placements)
    ck = checkpoint.Checkpointer(ckpt_dir, chief=rank == 0)
    assert ck.save(1, state)
    saved = {n: p.full_tensor().clone() for n, p in model.named_parameters()}
    moments = {n: {k: (v.full_tensor() if isinstance(v, DTensor) else v)
                   .clone() for k, v in state["opt_state"].state[p].items()}
               for n, p in model.named_parameters()}
    dist.destroy_process_group()
    if rank == 0:
        # ... restores bitwise at 1 rank through respec_like
        from tensorflowonspark_tpu_torch import util

        _init(0, 1, util.find_free_port())
        mesh1 = build_mesh({"model": 1})
        like = checkpoint.respec_like(state, mesh1)
        assert like["params"]["deep_embeddings.weight"].placements == \
            (Shard(0),)
        got = checkpoint.Checkpointer(ckpt_dir).restore(like)
        res["restored_step"] = got["step"]
        res["restore_bitwise"] = all(
            torch.equal(p.full_tensor(), saved[n])
            for n, p in got.model.named_parameters())
        res["moments_bitwise"] = all(
            torch.equal(v.full_tensor() if isinstance(v, DTensor) else v,
                        moments[n][k])
            for n, p in got.model.named_parameters()
            for k, v in got["opt_state"].state[p].items())
        with pytest.raises(ValueError, match="deep_embeddings.*model"):
            checkpoint.respec_like(state, build_mesh({"data": 1}))
        # alone, a non-chief holding sharded state refuses to save
        with pytest.raises(ValueError, match="non-replicated"):
            checkpoint.Checkpointer(ckpt_dir, chief=False).save(2, got)
        res["refused_sharded_non_chief"] = True
        dist.destroy_process_group()
    _save(out_dir, rank, res)


# -- the 4-rank spawn -----------------------------------------------------


def _tiny_bert():
    from tensorflowonspark_tpu_torch.models import bert

    cfg = bert.bert_tiny()
    model = bert.BertForSequenceClassification(cfg, num_classes=3)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.eval(), cfg


#: the reference decode test's sizes (tests/test_generation.py)
DEC_V, DEC_H, DEC_NH, DEC_L, DEC_MAXLEN, DEC_NEW = 17, 32, 4, 2, 32, 5
#: the decode meshes, each over the 4 ranks
DEC_MESHES = ({"data": 2, "model": 2}, {"data": 1, "model": 4})


def _mesh_key(shape):
    return "{}x{}".format(shape["data"], shape["model"])


def _tp_decode(rank, dec_in, out_dir):
    """TP decode on this rank (4 gloo ranks): the port DecoderLM on the
    flax weights, replicated and laid out by DECODER_TP_RULES on each of
    DEC_MESHES, decoded greedily and sampled; one decode step's
    collectives recorded; the 2-head model at tp 4 (q/k/v replicated);
    and the paged branch's refusal."""
    import copy

    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import generation, tp_scaling_model
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
    from tensorflowonspark_tpu_torch.parallel import build_mesh
    from tensorflowonspark_tpu_torch.parallel.collectives import (
        CollectiveRecorder)
    from torch.distributed.tensor.experimental import implicit_replication

    state, prompt = dec_in
    base = DecoderLM(DEC_V, hidden=DEC_H, num_heads=DEC_NH,
                     num_layers=DEC_L, max_len=DEC_MAXLEN)
    base.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    out = {"replicated": generation.generate(
        base, prompt, DEC_NEW, device="cpu").numpy()}
    base_step = tp_scaling_model.decode_step_traffic(base, prompt,
                                                     device="cpu")
    for shape in DEC_MESHES:
        m = sharding.distribute_params(
            copy.deepcopy(base), build_mesh(shape, device="cpu"),
            sharding.DECODER_TP_RULES)
        q = m.blocks[0].attn.query.weight
        got = {"tokens": generation.generate(m, prompt, DEC_NEW,
                                             device="cpu").numpy(),
               "query_model_placement": str(q.placements[1]),
               "query_row_split": q.placements[1].is_shard(0)
               and q.placements[0].is_replicate(),
               "cache_heads": generation.init_cache(m, 2, DEC_MAXLEN)[0][
                   "cached_key"].shape[2],
               "step": tp_scaling_model.decode_step_traffic(m, prompt,
                                                            device="cpu")}
        got["step"]["logits"] = (got["step"]["logits"]
                                 - base_step["logits"]).abs().max().item()
        # seeded alike on every rank: the same draws
        got["sampled"] = generation.generate(
            m, prompt, DEC_NEW, temperature=0.8, device="cpu",
            generator=torch.Generator().manual_seed(11)).numpy()
        out[_mesh_key(shape)] = got
    # seeded differently: the picks' check raises on every rank
    try:
        generation.generate(m, prompt, DEC_NEW, temperature=5.0,
                            device="cpu",
                            generator=torch.Generator().manual_seed(
                                100 + rank))
        out["mismatch_raised"] = False
    except RuntimeError as e:
        out["mismatch_raised"] = "different tokens" in str(e)
    # the paged branch refuses a TP model
    tables = torch.ones((2, 2), dtype=torch.int32)
    layer = {"cached_key": torch.zeros(3, 16, DEC_NH, DEC_H // DEC_NH),
             "cached_value": torch.zeros(3, 16, DEC_NH, DEC_H // DEC_NH)}
    try:
        with torch.no_grad(), implicit_replication():
            m(torch.zeros((2, 1), dtype=torch.int32), [layer] * DEC_L,
              torch.zeros(2, dtype=torch.int32), tables)
        out["paged_refused"] = None
    except ValueError as e:
        out["paged_refused"] = str(e)
    # the recorder counts the port's own torch.distributed calls too
    with CollectiveRecorder() as rec:
        dist.all_reduce(torch.ones(3))
    out["c10d_recorded"] = rec.families
    # 2 heads at tp 4: q/k/v replicate (whole heads only), the MLP splits
    two = DecoderLM(DEC_V, hidden=DEC_H, num_heads=2, num_layers=DEC_L,
                    max_len=DEC_MAXLEN)
    two.init_weights(torch.Generator().manual_seed(3), std=0.3)
    want = generation.generate(two, prompt, DEC_NEW, device="cpu")
    sharding.distribute_params(two, build_mesh({"data": 1, "model": 4},
                                               device="cpu"),
                               sharding.DECODER_TP_RULES)
    out["two_heads"] = {
        "equal": torch.equal(generation.generate(two, prompt, DEC_NEW,
                                                 device="cpu"), want),
        "query_replicated": all(
            p.is_replicate() for p in two.blocks[0].attn.query.weight
            .placements),
        "mlp_in_split": two.blocks[0].mlp_in.weight.placements[1]
        .is_shard(0),
        "cache_heads": generation.init_cache(two, 2, DEC_MAXLEN)[0][
            "cached_key"].shape[2]}
    return out


def _worker_four(rank, world, port, out_dir, moe_in, pipe_in, dec_in):
    from torch.distributed.tensor import DTensor

    from tensorflowonspark_tpu_torch import training
    from tensorflowonspark_tpu_torch.models.widedeep import ctr_loss
    from tensorflowonspark_tpu_torch.parallel import build_mesh
    from tensorflowonspark_tpu_torch.parallel import moe, pipeline

    _init(rank, world, port)
    res = {"ring": _ring_vs_lockstep(rank, world)}

    # expert parallelism: 8 experts over 4 ranks, this rank's 2
    mesh = build_mesh({"expert": 4})
    x, router, w_in, w_out, tgt = (torch.tensor(a) for a in moe_in)
    per = w_in.shape[0] // 4
    x.requires_grad_()
    router.requires_grad_()
    wi = w_in[rank * per:(rank + 1) * per].clone().requires_grad_()
    wo = w_out[rank * per:(rank + 1) * per].clone().requires_grad_()
    y, aux = moe.moe_ffn(x, router, wi, wo, mesh)
    (((y - tgt) ** 2).mean() + 0.01 * aux).backward()
    res["moe"] = {"y": y.detach(), "aux": aux.detach(), "dx": x.grad,
                  "drouter": router.grad, "dw_in": wi.grad,
                  "dw_out": wo.grad}

    # pipeline parallelism: 4 stages, this rank's stage
    mesh = build_mesh({"stage": 4})
    ws, xs, tgt = (torch.tensor(a) for a in pipe_in)
    w = ws[rank].clone().requires_grad_()
    out = pipeline.pipeline_apply(lambda p, h: torch.tanh(h @ p), w, xs,
                                  mesh)
    ((out - tgt) ** 2).mean().backward()
    res["pipe"] = {"out": out.detach(), "dw": w.grad}

    # TP: BERT-tiny forward with sharded params == replicated
    mesh = build_mesh({"data": 2, "model": 2})
    model, cfg = _tiny_bert()
    ids = torch.arange(32).reshape(2, 16) % cfg.vocab_size
    with torch.no_grad():
        want = model(ids)
        cfg.use_flash = False       # the einsum branch
        want_e = model(ids)
        cfg.use_flash = True
    sharding.distribute_params(model, mesh, sharding.BERT_TP_RULES)
    from torch.distributed.tensor.experimental import implicit_replication
    with torch.no_grad(), implicit_replication():
        got = model(ids)
        cfg.use_flash = False       # DTensor q/k/v: head-major
        got_e = model(ids)
        cfg.use_flash = True
    res["tp_bert"] = ((got.full_tensor() - want).abs().max().item(),
                      tuple(model.bert.layer_0.ffn_in.weight.placements),
                      (got_e.full_tensor() - want_e).abs().max().item())

    # the embedding lookup on a row-sharded table == the replicated table
    table = torch.nn.Embedding(64, 8)
    table.weight.data.copy_(torch.tensor(
        np.random.RandomState(3).randn(64, 8).astype(np.float32)))
    ref = table(torch.arange(0, 64, 5)).detach()
    sharding.distribute_params(table, mesh, ((r"weight", ("model", None)),))
    with implicit_replication():
        got = table(torch.arange(0, 64, 5))
    res["lookup"] = torch.equal(got.full_tensor(), ref)

    # the Wide & Deep TP step on {data: 2, model: 2}: losses against the
    # 2-rank DDP run; the table trains and keeps Shard(0)
    model = sharding.distribute_params(_widedeep(), mesh,
                                       sharding.WIDEDEEP_TP_RULES)
    trainer = training.Trainer(model, training.adamw(0.05),
                               loss_fn=ctr_loss, input_keys=("dense", "cat"),
                               device="cpu", mesh=mesh)
    state = trainer.init()
    before = model.deep_embeddings.weight.full_tensor().clone()
    data_rank = mesh.get_local_rank("data")
    state, res["tp_losses"] = _train_losses(trainer, state, data_rank)
    table = model.deep_embeddings.weight
    res["tp_table"] = {
        "moved": (table.full_tensor() - before).abs().max().item(),
        "placements": tuple(table.placements),
        "local_rows": table.to_local().shape[0],
        "moments": tuple(state["opt_state"].state[table]["exp_avg"]
                         .placements),
        "is_dtensor": isinstance(table, DTensor),
        "world_size": trainer.world_size}
    res["inferred"] = tuple(build_mesh({"data": -1, "model": 2}).shape)
    res["tp_decode"] = _tp_decode(rank, dec_in, out_dir)
    _save(out_dir, rank, res)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two")
    return _spawn(_worker_two, 2, out, str(out / "ckpt"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("four")
    return _spawn(_worker_four, 4, out, _moe_inputs(), _pipe_inputs(),
                  _decoder_inputs())


# -- what the ranks showed ------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_p2p_ring_matches_lockstep(two_ranks, four_ranks, world):
    """The P2P ring (batch_isend_irecv rotation, its inverse in the
    backward) on 2 and 4 gloo ranks equals the lockstep ring within
    1e-6, out and gradients, every schedule (contiguous causal and not,
    zigzag, the online ring)."""
    results = two_ranks if world == 2 else four_ranks
    for r in results:
        for name, err in r["ring"].items():
            assert err <= 1e-6, (world, name, err)


def _moe_inputs():
    rng = np.random.RandomState(0)
    t, h, f, e = 32, 16, 32, 8
    return (rng.randn(t, h).astype(np.float32),
            (rng.randn(h, e) * 0.5).astype(np.float32),
            (rng.randn(e, h, f) * (2.0 / h) ** 0.5).astype(np.float32),
            (rng.randn(e, f, h) * (2.0 / f) ** 0.5).astype(np.float32),
            rng.randn(t, h).astype(np.float32))


def test_moe_expert_parallel_matches_jax(four_ranks):
    """moe_ffn on 4 gloo ranks ({"expert": 4}, 2 experts a rank) against
    the JAX package's on 4 virtual devices, same weights: output, aux
    and the gradients of ``mse + 0.01 aux`` within 1e-5 (both compute
    float32 einsums and the tanh GELU in another summation order)."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_tpu.parallel.moe import moe_ffn

    x, router, w_in, w_out, tgt = _moe_inputs()
    mesh = build_mesh({"expert": 4}, devices=jax.devices()[:4])

    def loss(x, r, wi, wo):
        y, aux = moe_ffn(x, r, wi, wo, mesh)
        return jnp.mean((y - tgt) ** 2) + 0.01 * aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(x, router, w_in, w_out)
    per = w_in.shape[0] // 4
    for r, got in enumerate(four_ranks):
        m = got["moe"]
        np.testing.assert_allclose(m["y"].numpy(), np.asarray(y), atol=1e-5)
        assert abs(float(m["aux"]) - float(aux)) <= 1e-5
        assert float(aux) > 0
        np.testing.assert_allclose(m["dx"].numpy(), np.asarray(grads[0]),
                                   atol=1e-5)
        np.testing.assert_allclose(m["drouter"].numpy(),
                                   np.asarray(grads[1]), atol=1e-5)
        sl = slice(r * per, (r + 1) * per)
        np.testing.assert_allclose(m["dw_in"].numpy(),
                                   np.asarray(grads[2])[sl], atol=1e-5)
        np.testing.assert_allclose(m["dw_out"].numpy(),
                                   np.asarray(grads[3])[sl], atol=1e-5)


def test_top1_gating_and_gelu_match_jax():
    """The router and the activation in process: top1_gating's one-hots,
    gates and aux equal JAX's, and moe's default GELU is jax.nn.gelu's
    tanh form (torch's F.gelu default is the erf form)."""
    import jax

    from tensorflowonspark_tpu.parallel.moe import top1_gating
    from tensorflowonspark_tpu_torch.parallel import moe

    logits = np.random.RandomState(1).randn(32, 8).astype(np.float32)
    for got, want in zip(moe.top1_gating(torch.tensor(logits)),
                         top1_gating(logits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(moe.gelu_tanh(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    r, wi, wo = moe.init_moe_params(g, 8, 16, 32)
    assert r.shape == (16, 8) and wi.shape == (8, 16, 32) \
        and wo.shape == (8, 32, 16)


def _pipe_inputs():
    rng = np.random.RandomState(9)
    h, m, mb = 8, 6, 3
    return ((rng.randn(4, h, h) * 0.4).astype(np.float32),
            rng.randn(m, mb, h).astype(np.float32),
            rng.randn(m, mb, h).astype(np.float32))


def test_pipeline_apply_matches_jax(four_ranks):
    """pipeline_apply on 4 gloo ranks ({"stage": 4}, M 6) against the JAX
    package's on 4 virtual devices: the replicated output and each
    stage's weight gradient within 1e-5 (test_pipeline_apply and
    test_pipeline_apply_is_differentiable's stage, tanh(x @ w))."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_tpu.parallel.pipeline import pipeline_apply

    ws, xs, tgt = _pipe_inputs()
    mesh = build_mesh({"stage": 4}, devices=jax.devices()[:4])

    def loss(p):
        out = pipeline_apply(lambda q, h: jnp.tanh(h @ q["w"]), p, xs, mesh)
        return jnp.mean((out - tgt) ** 2), out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)({"w": ws})
    for r, got in enumerate(four_ranks):
        np.testing.assert_allclose(got["pipe"]["out"].numpy(),
                                   np.asarray(out), atol=1e-5)
        np.testing.assert_allclose(got["pipe"]["dw"].numpy(),
                                   np.asarray(g["w"])[r], atol=1e-5)


def test_tp_forward_matches_replicated(four_ranks):
    """BERT-tiny's forward with BERT_TP_RULES params on a {"data": 2,
    "model": 2} mesh equals the replicated forward within the
    reference's 1e-2 (bfloat16 products summed in another order), on
    the flash branch and on the einsum branch (head-major under
    DTensor)."""
    for r in four_ranks:
        err, placements, err_einsum = r["tp_bert"]
        assert err <= 1e-2, err
        assert err_einsum <= 1e-2, err_einsum
        assert placements[1].is_shard(0)


@functools.lru_cache(maxsize=None)
def _decoder_flax():
    """The reference decode test's flax DecoderLM (``PRNGKey(0)``) and
    its prompt (``RandomState(5)``, ``(2, 6)``)."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models.decoder import DecoderLM

    params = DecoderLM(vocab=DEC_V, hidden=DEC_H, num_heads=DEC_NH,
                       num_layers=DEC_L, max_len=DEC_MAXLEN,
                       decode=False).init(
        jax.random.PRNGKey(0), jnp.zeros((2, DEC_MAXLEN), jnp.int32))[
            "params"]
    prompt = np.random.RandomState(5).randint(0, DEC_V, (2, 6)).astype(
        np.int32)
    return params, prompt


def _decoder_inputs():
    """The spawn's decoder weights (through ``convert.from_flax``, as
    numpy) and prompt."""
    from tensorflowonspark_tpu_torch import convert

    params, prompt = _decoder_flax()
    return ({k: v.numpy() for k, v in convert.from_flax(params).items()},
            prompt)


def test_tp_decode_matches_replicated_and_jax(four_ranks):
    """generate of the port DecoderLM laid out by DECODER_TP_RULES on
    {"data": 2, "model": 2} and {"data": 1, "model": 4} (4 gloo ranks)
    gives, on every rank, bitwise the tokens of the port's replicated
    generate and of the JAX package's replicated generate on the same
    flax weights (temperature 0, the reference test's sizes); each
    rank's query weight is Shard(0) on ``model`` and its cache holds
    4 / tp heads."""
    from tensorflowonspark_tpu import generation as jgen
    from tensorflowonspark_tpu.models.decoder import DecoderLM

    params, prompt = _decoder_flax()
    decode_model = DecoderLM(vocab=DEC_V, hidden=DEC_H, num_heads=DEC_NH,
                             num_layers=DEC_L, max_len=DEC_MAXLEN,
                             decode=True)
    want = np.asarray(jgen.generate(decode_model, params, prompt, DEC_NEW))
    for r in four_ranks:
        got = r["tp_decode"]
        np.testing.assert_array_equal(got["replicated"], want)
        for shape in DEC_MESHES:
            m = got[_mesh_key(shape)]
            np.testing.assert_array_equal(m["tokens"], want,
                                          err_msg=str(shape))
            assert m["query_row_split"], m["query_model_placement"]
            assert m["cache_heads"] == DEC_NH // shape["model"]


def test_tp_decode_sampling_agrees_across_ranks(four_ranks):
    """At temperature 0.8 with every rank's generator seeded alike, all
    4 ranks draw the same tokens on both meshes (the JAX PRNG differs by
    construction, so no JAX comparison); seeded differently, the picks'
    check raises on every rank instead of decoding apart."""
    for shape in DEC_MESHES:
        key = _mesh_key(shape)
        first = four_ranks[0]["tp_decode"][key]["sampled"]
        assert first.shape == (2, 6 + DEC_NEW)
        for r in four_ranks:
            np.testing.assert_array_equal(r["tp_decode"][key]["sampled"],
                                          first)
    assert all(r["tp_decode"]["mismatch_raised"] for r in four_ranks)


def test_tp_decode_two_heads_at_tp4_replicates_heads(four_ranks):
    """2 heads on {"data": 1, "model": 4}: whole heads do not divide, so
    q/k/v stay replicated (each rank's cache holds both heads) while the
    MLP still splits, and the tokens equal the replicated run's."""
    for r in four_ranks:
        two = r["tp_decode"]["two_heads"]
        assert two["equal"] and two["query_replicated"]
        assert two["mlp_in_split"] and two["cache_heads"] == 2


def test_tp_decode_step_traffic_is_megatron(four_ranks):
    """One decode step moves exactly the megatron count on both meshes:
    2 all-reduces a layer (after attn.out and mlp_out) of the float32
    [B, 1, H] partial sums, 2 x L x B x H x 4 bytes, and no all-gather;
    the recorder counts the port's own torch.distributed calls too."""
    want = 2 * DEC_L * 2 * DEC_H * 4
    for r in four_ranks:
        got = r["tp_decode"]
        for shape in DEC_MESHES:
            step = got[_mesh_key(shape)]["step"]
            assert step["bytes"] == want, step
            # the teacher-forced logits equal the replicated model's
            assert step["logits"] < 1e-5, step
            assert step["families"] == {
                "all_reduce": {"ops": 2 * DEC_L, "bytes": want}}, step
        assert got["c10d_recorded"] == {"all_reduce": {"ops": 1,
                                                       "bytes": 12}}


def test_tp_paged_branch_refuses_a_tp_model(four_ranks):
    """The paged cache takes no TP model: a ValueError that names the
    contiguous path, never a wrong decode."""
    for r in four_ranks:
        msg = r["tp_decode"]["paged_refused"]
        assert msg is not None and "paged" in msg and "contiguous" in msg


def test_tp_scaling_model_measures_collective_bytes(tmp_path):
    """``tp_scaling_model.main(["--tp", "2", "--device", "cpu"])`` in its
    own group of 2 gloo ranks (spawned from this test, so a slow group
    fails this test alone): the BERT-tiny TP step ran, its collectives
    moved bytes, and the decode row equals the megatron count."""
    from tensorflowonspark_tpu_torch import tp_scaling_model

    path = str(tmp_path / "tp_scaling.json")
    assert tp_scaling_model.main(
        ["--tp", "2", "--device", "cpu", "--out", path]) == 0
    with open(path) as f:
        rep = json.load(f)
    assert rep["ranks"] == "gloo ranks on the CPU"
    assert rep["tp"] == 2 and rep["step_executed"] and rep["layers"] == 2
    assert rep["total_collective_bytes"] > 0
    assert rep["total_collective_bytes"] == sum(
        f["bytes"] for f in rep["collectives"].values())
    assert rep["bytes_per_layer_per_activation"] > 0
    row = rep["decode"]
    assert row["bytes_per_token"] == row["megatron_bytes_per_token"] == \
        2 * 2 * 8 * 64 * 4
    assert row["matches_megatron"] and row["local_heads"] == 2


def test_tp_scaling_model_runs_on_the_cards_unless_asked(monkeypatch):
    """With no ``--device`` the widths run as NCCL ranks, one a card: no
    card, or fewer cards than ``tp``, is refused before a rank starts,
    never rerouted to the CPU."""
    from tensorflowonspark_tpu_torch import tp_scaling_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp_scaling_model.main(["--tp", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tp_scaling_model.ranks_of() == "cuda"
    with pytest.raises(RuntimeError, match="tp 2 needs 2 cards"):
        tp_scaling_model.run_width(2)
    with pytest.raises(RuntimeError, match="tp 4 needs 4 cards"):
        tp_scaling_model.sweep([4])
    with pytest.raises(ValueError, match="2 or more"):
        tp_scaling_model.run_width(1, "cpu")


def test_widedeep_sharded_embedding_training_step(two_ranks, four_ranks):
    """The Trainer's sharded step on {"data": 2, "model": 2}: the
    row-sharded tables train and keep Shard(0) (each rank holding half
    the rows, the Adam moments on the same placements), the lookup on a
    row-sharded table equals the replicated table's, and the losses
    equal the DDP path's on a {"data": 2} mesh of 2 ranks fed the same
    data-rank batches within 1e-5 (float32; the model axis only
    reassociates the sums of the sharded products)."""
    assert two_ranks[0]["ddp_uses_ddp"]
    ddp = two_ranks[0]["ddp_losses"]
    assert two_ranks[1]["ddp_losses"] == ddp
    for r in four_ranks:
        assert r["lookup"]
        t = r["tp_table"]
        assert t["is_dtensor"] and t["moved"] > 0
        assert t["placements"][1].is_shard(0) and t["moments"][1].is_shard(0)
        assert t["local_rows"] == 6 * 64 // 2
        assert t["world_size"] == 2
        np.testing.assert_allclose(r["tp_losses"], ddp, rtol=1e-5)
        assert r["inferred"] == (2, 2)


def test_sharded_checkpoint_restores_across_meshes(two_ranks):
    """A DTensor state saved at 2 ranks ({"model": 2}, tables sharded)
    restores at 1 rank through respec_like, bitwise (parameters and Adam
    moments); a mesh without the sharded axis is refused naming the
    leaf and the axis; a sharded state is not fully replicated, and a
    lone non-chief holding one refuses to save (the reference's rule)."""
    r0 = two_ranks[0]
    assert r0["sharded_replicated"] is False
    assert r0["table_placements"][0].is_shard(0)
    assert r0["restored_step"] == 1
    assert r0["restore_bitwise"] and r0["moments_bitwise"]
    assert r0["refused_sharded_non_chief"]


def test_build_hybrid_mesh_over_hosts(two_ranks):
    """Two ranks, their hosts gathered (one machine): the DCN axes come
    first and an inferred axis takes both ranks, on either side. The
    layout over several hosts is held as pure functions
    (``test_host_major_layout``, the ``hybrid_mesh_shape`` tests)."""
    names, shape, grid = two_ranks[0]["hybrid"]
    assert names == ("data", "model") and shape == (2, 1)
    assert grid == [[0], [1]]
    assert two_ranks[1]["hybrid_gathered"] == ((1, 2), [[0, 1]])


def test_sharding_placements():
    """``data_parallel_sharding`` splits the batch dim over the data axis
    and replicates elsewhere, as the reference's ``PartitionSpec(data)``;
    ``replicated_sharding`` replicates everywhere; a spec naming an axis
    the mesh lacks is refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _fake_mesh(data=2, model=2)
    assert tmesh.data_parallel_sharding(mesh) == [Shard(0), Replicate()]
    assert tmesh.replicated_sharding(mesh) == [Replicate(), Replicate()]
    assert sharding.placements_of((None, "model"), mesh) == \
        [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="'seq'"):
        sharding.placements_of(("seq",), mesh)


# -- in process: the mesh arithmetic and the catalogs ---------------------


def test_respec_for_width_matches_reference():
    from tensorflowonspark_tpu.parallel.mesh import respec_for_width as ref

    cases = [({"data": 2, "model": 4}, 4), ({"data": 1, "model": 4}, 8),
             ({"model": 2, "data": 4}, 16), (None, 3), ({"model": 2}, 8),
             ({"data": -1, "model": 2}, 6)]
    for shapes, n in cases:
        got = tmesh.respec_for_width(shapes, n)
        assert got == ref(shapes, n) and list(got) == list(ref(shapes, n))


def test_respec_for_width_loud_errors_name_the_axes():
    with pytest.raises(ValueError, match=r"model.*4"):
        tmesh.respec_for_width({"data": 2, "model": 4}, 6)
    with pytest.raises(ValueError, match="multiples of 4"):
        tmesh.respec_for_width({"data": 2, "model": 4}, 2)
    with pytest.raises(ValueError, match="model"):
        tmesh.respec_for_width({"data": 2, "model": -1}, 8)
    with pytest.raises(ValueError):
        tmesh.respec_for_width({"data": 2}, 0)


def test_build_mesh_error_split_names_failing_axis():
    """The reference's build_mesh errors, from the shape arithmetic that
    needs no process group (8 ranks)."""
    with pytest.raises(ValueError, match=r"infer axis 'data'.*size 0"):
        tmesh.mesh_shape({"data": -1, "model": 0}, 8)
    with pytest.raises(ValueError,
                       match=r"infer axis 'data'.*do not divide"):
        tmesh.mesh_shape({"data": -1, "model": 3}, 8)
    with pytest.raises(ValueError, match=r"\['model'\]"):
        tmesh.mesh_shape({"data": -1, "model": 0}, 8)
    with pytest.raises(ValueError, match="at most one"):
        tmesh.mesh_shape({"data": -1, "model": -1}, 8)
    with pytest.raises(ValueError, match="needs 6 devices but 8"):
        tmesh.mesh_shape({"data": 2, "model": 3}, 8)
    assert tmesh.mesh_shape(None, 8) == (["data"], [8])
    assert tmesh.mesh_shape({"data": -1, "model": 2}, 8) == \
        (["data", "model"], [4, 2])


def test_build_hybrid_mesh_shape_errors_and_inference():
    hs = tmesh.hybrid_mesh_shape
    with pytest.raises(ValueError, match="exactly one"):
        hs({"data": 2}, {"data": 4}, 8)
    with pytest.raises(ValueError, match="devices"):
        hs({"data": 3}, {"model": 4}, 8)
    assert hs({"data": -1}, {"model": 4}, 8) == (["data", "model"], [2, 4])
    assert hs({"data": 2}, {"model": -1}, 8) == (["data", "model"], [2, 4])
    with pytest.raises(ValueError, match="at most one"):
        hs({"data": -1}, {"model": -1}, 8)
    with pytest.raises(ValueError, match=r"hybrid axis 'data'"):
        hs({"data": -1}, {"model": 3}, 8)
    with pytest.raises(ValueError, match=r"\['model'\]"):
        hs({"data": -1}, {"model": 0}, 8)
    # the factoring check on hosts (the reference's slices): the DCN
    # axes must cover the hosts exactly
    with pytest.raises(ValueError, match="dcn axes must exactly cover"):
        hs({"data": 4}, {"model": 2}, 8, n_hosts=2)
    assert hs({"data": 2}, {"model": 4}, 8, n_hosts=2) == \
        (["data", "model"], [2, 4])


def test_host_major_layout():
    """DCN axes outer, ICI inner: every inner block is one host's ranks,
    hosts in order of first appearance."""
    order, n = tmesh.host_major(list(range(8)),
                                ["a", "b", "a", "b", "a", "b", "a", "b"])
    assert n == 2 and order == [0, 2, 4, 6, 1, 3, 5, 7]
    assert tmesh.host_major([0, 1], ["h", "h"]) == ([0, 1], 1)
    with pytest.raises(ValueError, match="different rank counts"):
        tmesh.host_major([0, 1, 2], ["a", "a", "b"])


def _fake_mesh(**axes):
    return types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 shape=tuple(axes.values()))


def _shard_ids(shape, spec, sizes):
    """Each element's shard index on each mesh axis of ``sizes`` (0
    where replicated), one decimal digit per axis: what a layout puts on
    which rank, whichever tensor dim carries the axis."""
    ids = np.zeros(shape, np.float32)
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        idx = np.arange(shape[i]) // (shape[i] // sizes[axis])
        view = [1] * len(shape)
        view[i] = shape[i]
        ids = ids + idx.reshape(view) * 10 ** list(sizes).index(axis)
    return ids


def _flax_and_port(family, heads=4):
    """(flax params, the port model, the port's name map, the reference
    catalog, the port catalog) for each catalog's model family (the
    decoder with ``heads`` heads; BERT-tiny has 2)."""
    import jax

    from tensorflowonspark_tpu import models as jmodels  # noqa: F401
    from tensorflowonspark_tpu.parallel import sharding as jsharding
    from tensorflowonspark_tpu_torch import convert

    key = jax.random.PRNGKey(0)
    if family == "bert":
        from tensorflowonspark_tpu.models import bert as jb
        from tensorflowonspark_tpu_torch.models import bert as tb

        params = jb.BertForQuestionAnswering(jb.bert_tiny()).init(
            key, np.zeros((2, 16), np.int32))["params"]
        return (params, tb.BertForQuestionAnswering(tb.bert_tiny()),
                convert.tree_from_flax, jsharding.BERT_TP_RULES,
                sharding.BERT_TP_RULES)
    if family == "widedeep":
        from tensorflowonspark_tpu.models import widedeep as jw
        from tensorflowonspark_tpu_torch.models import widedeep as tw

        kw = dict(num_dense=4, num_cat=6, hash_buckets=64, embed_dim=8,
                  mlp_sizes=(16, 16))
        params = jw.WideDeep(**kw).init(
            key, np.zeros((2, 4), np.float32),
            np.zeros((2, 6), np.int32))["params"]
        return (params, tw.WideDeep(**kw), convert.tree_from_flax,
                jsharding.WIDEDEEP_TP_RULES, sharding.WIDEDEEP_TP_RULES)
    if family == "resnet":
        from tensorflowonspark_tpu.models import resnet as jr
        from tensorflowonspark_tpu_torch.models import resnet as tr

        variables = jr.ResNet(stage_sizes=(1, 1), num_classes=10,
                              width=8).init(
            key, np.zeros((1, 32, 32, 3), np.float32), train=False)
        return (variables["params"],
                tr.ResNet(stage_sizes=(1, 1), num_classes=10, width=8),
                convert.tree_from_flax, jsharding.RESNET_TP_RULES,
                sharding.RESNET_TP_RULES)
    from tensorflowonspark_tpu.models import decoder as jd
    from tensorflowonspark_tpu_torch.models import decoder as td

    params = jd.DecoderLM(vocab=64, hidden=32, num_heads=heads,
                          num_layers=2, max_len=16).init(
        key, np.zeros((1, 8), np.int32))["params"]
    return (params, td.DecoderLM(vocab=64, hidden=32, num_heads=heads,
                                 num_layers=2, max_len=16),
            convert.from_flax, jsharding.DECODER_TP_RULES,
            sharding.DECODER_TP_RULES)


def _spec_of(placements, names):
    """The spec a list of placements (one per mesh axis of ``names``)
    gives each tensor dim: the axis that shards it, or None."""
    spec = {}
    for axis, p in zip(names, placements):
        if p.is_shard():
            spec[p.dim] = axis
    return tuple(spec.get(i) for i in range(max(spec, default=-1) + 1))


#: family -> (decoder heads, model-axis width): the 4-head decoder and
#: BERT-tiny's 2 heads at model 2 divide; 2 heads at model 4 do not, and
#: the reference then replicates the head axis
CATALOG_CASES = {"bert": (4, 2), "widedeep": (4, 2), "resnet": (4, 2),
                 "decoder": (4, 2), "bert_2heads_model4": (4, 4),
                 "decoder_2heads_model4": (2, 4)}


@pytest.mark.parametrize("family", list(CATALOG_CASES))
def test_tp_catalog_matches_reference(family):
    """Each port catalog lays every parameter out as the reference's
    catalog lays the flax leaf it comes from: each flax leaf carries the
    shard index of its elements under the reference's layout (its spec
    through its ``constrain_spec`` on the case's model-axis width),
    ``convert``'s name map carries those tensors onto the port's names
    and layouts, and the port's ``tree_shardings`` must give every
    element the same shard index. At widths the heads divide, at least
    one parameter per rule is sharded; with 2 heads at model 4 the
    attention projections replicate (whole heads only) and the MLP /
    FFN still splits."""
    import jax

    from tensorflowonspark_tpu.parallel.sharding import (
        constrain_spec as jconstrain)
    from tensorflowonspark_tpu.parallel.sharding import (
        param_path_specs as jspecs)

    heads, width = CATALOG_CASES[family]
    params, model, to_port, jrules, trules = _flax_and_port(
        family.split("_")[0], heads=heads)
    sizes = {"model": width}
    flax_specs = jspecs(params, jrules)
    jmesh = types.SimpleNamespace(shape=sizes)

    def encode(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        spec = jconstrain(flax_specs[name], np.shape(leaf), jmesh, name)
        return _shard_ids(np.shape(leaf), tuple(spec), sizes)

    encoded = jax.tree_util.tree_map_with_path(encode, params)
    want = to_port(encoded)
    got_placements = sharding.tree_shardings(model, _fake_mesh(**sizes),
                                             trules)
    named = dict(model.named_parameters())
    assert set(want) >= set(named), sorted(set(named) - set(want))
    sharded = set()
    for name, p in named.items():
        spec = _spec_of(got_placements[name], tuple(sizes))
        got = _shard_ids(tuple(p.shape), spec, sizes)
        np.testing.assert_array_equal(got, want[name].numpy(),
                                      err_msg=name)
        if any(a is not None for a in spec):
            sharded.add(name)
    if width == 2:
        assert len(sharded) >= len(trules) - 1, sorted(sharded)
    else:
        attn = [n for n in named if re.search(
            r"(attn|attention)\.(query|key|value|out)\.(weight|bias)", n)
            and not n.endswith("out.bias")]
        assert attn and not sharded & set(attn), sorted(sharded & set(attn))
        assert any(re.search(r"(mlp|ffn)_in\.weight", n) for n in sharded)


def test_tree_shardings_indivisible_dim_replicates():
    """A rule dim that doesn't divide its mesh axis degrades to a
    replicated dim: the 2-row type table at tp=4, and BERT's 2 heads at
    tp=4 — the fused head rows (64 of them, which 4 would divide) count
    whole heads, as the reference's head axis does — while the 128-wide
    FFN keeps its model axis. Fused head dims need the module (its
    attention's head size): a name -> tensor dict is refused."""
    from tensorflowonspark_tpu_torch.models import bert

    model = bert.BertForQuestionAnswering(bert.bert_tiny())
    mesh = _fake_mesh(data=2, model=4)
    rules = sharding.BERT_TP_RULES + ((r"type_embeddings", ("model",
                                                            None)),)
    got = sharding.tree_shardings(model, mesh, rules)
    assert got["bert.type_embeddings.weight"][1].is_replicate()
    assert got["bert.layer_0.ffn_in.weight"][1].is_shard(0)
    assert got["bert.layer_0.ffn_in.weight"][0].is_replicate()
    for name in ("query.weight", "query.bias", "out.weight"):
        assert got["bert.layer_0.attention." + name][1].is_replicate()
    got2 = sharding.tree_shardings(model, _fake_mesh(data=2, model=2),
                                   rules)
    assert got2["bert.layer_0.attention.query.weight"][1].is_shard(0)
    assert got2["bert.layer_0.attention.out.weight"][1].is_shard(1)
    with pytest.raises(ValueError, match="fused heads"):
        sharding.tree_shardings(dict(model.named_parameters()), mesh, rules)
    with pytest.raises(ValueError, match="longer than param"):
        sharding.param_path_specs(model, ((r"ffn_in\.bias", (None, "model")),))

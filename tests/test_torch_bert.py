"""The port's BERT against the JAX package's on the same weights, on the
CPU: the forward on both attention routes (the flash path, which the
JAX package runs through its XLA fallback on the CPU and the port
through the flash kernels' plain versions, and the einsum path), padded
and fully masked rows, the bfloat16 variant, the routing rule, the
dropout key's determinism, a 3-step QA fine-tune against the JAX
``Trainer``, and the bitwise ``convert`` round trip."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import training as jtraining
from tensorflowonspark_tpu.models import bert as jbert
from tensorflowonspark_tpu.parallel import build_mesh
from tensorflowonspark_tpu_torch import convert, training
from tensorflowonspark_tpu_torch.models import bert
from tensorflowonspark_tpu_torch.ops import flash_attention as fa

#: float32 against the reference: max |port - ref| over max |ref| (the
#: same products in other summation orders, two layers deep)
F32_RTOL = 1e-4
#: port flash path against port einsum path, float32: the same softmax
#: over the same live keys, once blockwise-online and once whole
ROUTE_RTOL = 1e-5
#: bfloat16 against the reference: each of the ~10 bfloat16 products in
#: series (embedding sum, q/k/v, P V, out, ffn_in, ffn_out per layer)
#: rounds to 8 significant bits, and the two frameworks round at
#: different points (XLA keeps float32 inside fused elementwise chains,
#: e.g. the GELU; torch rounds after each op), so each can differ by a
#: bfloat16 ulp (2^-8 relative); LayerNorm renormalises between layers.
#: 10 x 2^-8 ~ 4% of the largest logit bounds it; held at 2^-4 (6.25%).
#: A wrong mask, scale or head layout moves logits by O(1).
BF16_RTOL = 2.0 ** -4
B, S = 4, 32


def _rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cfgs(dtype=None, **kw):
    jc, tc = jbert.bert_tiny(), bert.bert_tiny()
    for c, d in ((jc, jnp.float32), (tc, torch.float32)):
        if dtype != "bf16":
            c.dtype = d
        for k, v in kw.items():
            setattr(c, k, v)
    return jc, tc


def _batch(seed=0, b=B, s=S, vocab=1024):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[0, 20:] = False        # a padded tail
    mask[1, 5:9] = False        # holes
    tt = (np.arange(s)[None, :] >= s // 2).astype(np.int32).repeat(b, 0)
    return ids, mask, tt


def _pair(jc, tc, cls="qa", seed=0):
    ids, mask, tt = _batch()
    if cls == "qa":
        jm, tm = jbert.BertForQuestionAnswering(jc), \
            bert.BertForQuestionAnswering(tc)
    else:
        jm, tm = jbert.BertForSequenceClassification(jc, num_classes=3), \
            bert.BertForSequenceClassification(tc, num_classes=3)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), ids, mask, tt)["params"])
    tm.load_state_dict(convert.bert_from_flax(params))
    return jm, tm, params


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("use_flash", [True, False])
def test_eval_forward_matches_flax_on_both_routes(use_flash):
    jc, tc = _cfgs(use_flash=use_flash)
    jm, tm, params = _pair(jc, tc)
    ids, mask, tt = _batch()
    want = jm.apply({"params": params}, ids, mask, tt, deterministic=True)
    with torch.no_grad():
        got = tm.eval()(*_t(ids, mask, tt))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (B, S)
        assert _rel(g, w) <= F32_RTOL


def test_sequence_classifier_matches_flax():
    jc, tc = _cfgs()
    jm, tm, params = _pair(jc, tc, cls="cls")
    ids, mask, tt = _batch()
    want = jm.apply({"params": params}, ids, mask, tt)
    with torch.no_grad():
        got = tm.eval()(*_t(ids, mask, tt))
    assert got.shape == (B, 3) and _rel(got, want) <= F32_RTOL


def test_flash_path_matches_einsum_path_with_a_fully_masked_row():
    """Mirrors the reference's test: the fused path and the einsum path
    are the same math, including a fully padded sequence (both give its
    attention zeros)."""
    _, tc = _cfgs()
    tm = bert.BertForQuestionAnswering(tc).eval()
    tm.init_weights(torch.Generator().manual_seed(0))
    ids, mask, tt = _batch()
    mask[2, :] = False
    ids, mask, tt = _t(ids, mask, tt)
    with torch.no_grad():
        flash = tm(ids, mask, tt)
        tc.use_flash = False
        einsum = tm(ids, mask, tt)
    for a, b in zip(flash, einsum):
        assert torch.isfinite(a).all()
        assert _rel(a, b.numpy()) <= ROUTE_RTOL
    # the fully masked row's attention is zero on both routes: its
    # output is a function of the embeddings alone
    layer = tm.bert.layer_0.attention
    x = torch.randn(B, S, tc.hidden_size, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        for use_flash in (True, False):
            tc.use_flash = use_flash
            out = layer(x, mask)
            assert torch.equal(out[2], layer.out.bias.expand(S, -1))


def test_bf16_forward_matches_flax():
    jc, tc = _cfgs(dtype="bf16")
    assert tc.dtype == torch.bfloat16
    jm, tm, params = _pair(jc, tc)
    ids, mask, tt = _batch()
    want = jm.apply({"params": params}, ids, mask, tt)
    with torch.no_grad():
        got = tm.eval()(*_t(ids, mask, tt))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32  # the float32 QA head
        assert _rel(g, w) <= BF16_RTOL


def test_routing_rule(monkeypatch):
    """Flash when use_flash, a tile divides S and dropout is inactive
    (eval, or dropout_rate 0); the einsum path otherwise."""
    calls = []
    real = fa.flash_attention

    def counting(*a, **kw):
        calls.append(kw.get("block_q"))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", counting)

    def routes(cfg, s, train):
        tm = bert.BertForQuestionAnswering(cfg)
        tm.train(train)
        ids = torch.zeros((2, s), dtype=torch.long)
        del calls[:]
        with torch.no_grad():
            tm(ids)
        return list(calls)

    _, tc = _cfgs()
    assert routes(tc, 32, False) == [32, 32]       # eval: one per layer
    assert routes(tc, 32, True) == []              # dropout live
    assert routes(tc, 48, False) == [16, 16]       # largest dividing tile
    assert routes(tc, 12, False) == []             # no tile divides 12
    _, tc0 = _cfgs(dropout_rate=0.0)
    assert routes(tc0, 32, True) == [32, 32]       # dropout-free training
    _, tcn = _cfgs(use_flash=False)
    assert routes(tcn, 32, False) == []
    assert bert._pick_block(384) == 128 and bert._pick_block(7) is None


def test_attn_impl_plain_routes_the_flash_path_to_its_plain_versions(
        monkeypatch):
    seen = []
    real = fa._route

    def spy(t, impl):
        seen.append(impl)
        return real(t, impl)

    monkeypatch.setattr(fa, "_route", spy)
    _, tc = _cfgs()
    tm = bert.BertForQuestionAnswering(tc).eval()
    ids = torch.zeros((2, 32), dtype=torch.long)
    with torch.no_grad():
        tm(ids, attn_impl="plain")
    assert seen and set(seen) == {"plain"}


def _qa_batch(seed, b=8, s=S, vocab=1024):
    ids, mask, tt = _batch(seed, b, s, vocab)
    rng = np.random.RandomState(seed + 100)
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": tt,
            "start_positions": rng.randint(0, s // 2, (b,)),
            "end_positions": rng.randint(0, s // 2, (b,))}


def test_three_step_qa_finetune_matches_the_jax_trainer():
    """bert_tiny at float32 with dropout off (JAX's dropout masks cannot
    be reproduced bitwise), adamw(1e-3) with optax's defaults, three
    steps on three batches: the JAX Trainer on its one-host mesh and the
    port's Trainer on the CPU, from the same converted weights."""
    jc, tc = _cfgs(dropout_rate=0.0)
    batches = [_qa_batch(i) for i in range(3)]
    keys = ("input_ids", "attention_mask", "token_type_ids")
    jm = jbert.BertForQuestionAnswering(jc)
    jt = jtraining.Trainer(jm, optax.adamw(1e-3), build_mesh(),
                           loss_fn=jbert.qa_span_loss, input_keys=keys)
    jstate = jt.init(jax.random.PRNGKey(0), batches[0])
    params = jax.tree.map(np.asarray, jstate["params"])
    tm = bert.BertForQuestionAnswering(tc)
    tm.load_state_dict(convert.bert_from_flax(params))
    tt = training.Trainer(tm, training.adamw(1e-3),
                          loss_fn=bert.qa_span_loss, input_keys=keys,
                          device="cpu")
    tstate = tt.init()
    for batch in batches:
        jstate, jm_ = jt.step(jstate, batch)
        tstate, tm_ = tt.step(tstate, batch)
        want, got = float(jm_["loss"]), float(tm_["loss"])
        assert abs(got - want) <= F32_RTOL * abs(want)
    # parameters after three Adam steps: each moved by ~lr per step in
    # both. Where a gradient is 0 in exact arithmetic, both sides hold
    # float noise, which Adam turns into lr-sized steps: the key bias
    # (it shifts every logit of a row alike), and the QA head's bias and
    # the last LayerNorm's bias (each shifts a sequence's start or end
    # logits alike at every position, which the span softmax ignores).
    # Those are held to 3 steps of lr, the rest to 1e-2 lr.
    got, _ = convert.bert_to_flax(tm.state_dict(), tc.num_heads)
    want = jax.tree.map(np.asarray, jstate["params"])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_w) == set(flat_g)
    for path, w in flat_w.items():
        err = np.abs(flat_g[path] - w).max()
        name = jax.tree_util.keystr(path)
        zero_grad = ("'key']['bias'" in name or name == "['qa_outputs']"
                     "['bias']" or name == "['bert']['layer_%d']['ln_ffn']"
                     "['bias']" % (tc.num_layers - 1))
        assert err <= (3e-3 if zero_grad else 1e-5), (name, err)


def _repeatable_step(trainer, state, batch, step):
    """Loss of one step taken from ``state`` at step number ``step``,
    with the model and optimizer restored afterwards."""
    model_sd = copy.deepcopy(trainer.model.state_dict())
    opt_sd = copy.deepcopy(state["opt_state"].state_dict())
    state["step"] = step
    _, m = trainer.step(state, batch)
    loss = m["loss"].clone()
    trainer.model.load_state_dict(model_sd)
    state["opt_state"].load_state_dict(opt_sd)
    return loss


def test_dropout_rng_masks_are_a_function_of_the_step():
    _, tc = _cfgs()
    assert tc.dropout_rate == 0.1
    tm = bert.BertForQuestionAnswering(tc)
    tm.init_weights(torch.Generator().manual_seed(0))
    keys = ("input_ids", "attention_mask", "token_type_ids")
    trainer = training.Trainer(tm, training.adamw(1e-3),
                               loss_fn=bert.qa_span_loss, input_keys=keys,
                               device="cpu", dropout_rng=True)
    state = trainer.init()
    batch = _qa_batch(0)
    calls = []
    real = fa.flash_attention
    try:
        fa.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
        before = torch.random.get_rng_state()
        a = _repeatable_step(trainer, state, batch, 5)
        b = _repeatable_step(trainer, state, batch, 5)
        c = _repeatable_step(trainer, state, batch, 6)
        after = torch.random.get_rng_state()
    finally:
        fa.flash_attention = real
    assert not calls  # dropout live: the einsum path
    assert torch.equal(a, b)          # step 5 twice: bitwise
    assert not torch.equal(a, c)      # step 6: other masks
    assert torch.equal(before, after)  # torch's generator left alone
    # and without the key, dropout draws from torch's generator
    trainer.dropout_rng = False
    torch.manual_seed(0)
    d = _repeatable_step(trainer, state, batch, 5)
    assert not torch.equal(torch.random.get_rng_state(),
                           torch.manual_seed(0).get_state())
    torch.manual_seed(0)
    e = _repeatable_step(trainer, state, batch, 5)
    assert torch.equal(d, e) and not torch.equal(d, a)


def test_convert_round_trip_is_bitwise():
    jc, tc = _cfgs()
    _, tm, params = _pair(jc, tc)
    back, extra = convert.bert_to_flax(tm.state_dict(), tc.num_heads)
    assert extra == {}
    for (p1, a), (p2, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert p1 == p2 and a.shape == b.shape and np.array_equal(a, b), p1
    again = convert.bert_from_flax(back)
    assert all(torch.equal(again[k], v) for k, v in tm.state_dict().items())
    with pytest.raises(ValueError):
        convert.tree_to_flax(tm.state_dict())  # DenseGeneral needs heads


def test_qa_span_loss_matches_the_reference():
    rng = np.random.RandomState(0)
    s, e = rng.randn(2, 4, 16).astype(np.float32)
    batch = {"start_positions": rng.randint(0, 16, (4,)),
             "end_positions": rng.randint(0, 16, (4,))}
    want = float(jbert.qa_span_loss((s, e), batch))
    got = float(bert.qa_span_loss(tuple(_t(s, e)),
                                  {k: torch.from_numpy(v)
                                   for k, v in batch.items()}))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_bert_base_has_the_references_widths():
    cfg = bert.bert_base()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.intermediate_size, cfg.max_position) == (
        30522, 768, 12, 12, 3072, 512)
    assert cfg.dtype == torch.bfloat16 and cfg.use_flash
    m = bert.BertForQuestionAnswering(cfg, device="meta")
    want = jax.eval_shape(lambda: jbert.BertForQuestionAnswering(
        jbert.bert_base()).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32)))
    n = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(want))
    assert sum(p.numel() for p in m.parameters()) == n

"""The port's solo generation, contiguous cache and KV block rows
against the JAX reference.

One flax ``DecoderLM`` is initialised from a seed and loaded into the
port's model by ``convert.from_flax``. Prompts made from a seed with
numpy run through the reference's ``generate_jit`` and the port's
``generate`` (greedy, with EOS freezing, ``max_new_tokens`` 0), and
through both contiguous slot primitives (``prefill_into_slot`` into a
dirty slot, then ``decode_step`` over rows at different cursors):
tokens equal, logits and the written cache rows within 1e-5 (float32:
only the summation order of the products differs). Block rows gathered
from a paged pool and scattered into another come back bitwise, int8
codes and scales as stored, and the speculative draft's weights are the
target's by identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import generation as jgen
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch import generation as tgen
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

V, H, NH, L, T = 64, 32, 4, 2, 64
FP32_TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    train = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    params = train.init(jax.random.PRNGKey(7),
                        jnp.zeros((2, T), jnp.int32))["params"]
    dec = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T,
                decode=True)
    return dec, params


def _port(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    m.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return m.eval()


def _eos_case(dec, params, prompts, max_new):
    """An EOS token the greedy stream emits mid-way in row 0, so the
    freeze is exercised."""
    out = np.asarray(jgen.generate_jit(dec, params, jnp.asarray(prompts),
                                       max_new))
    return int(out[0, prompts.shape[1] + max_new // 2])


def test_generate_equals_reference(lm):
    dec, params = lm
    model = _port(params)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, V, size=(3, 9)).astype(np.int32)
    eos = _eos_case(dec, params, prompts, 12)
    for kw in ({}, {"eos_token": eos, "pad_token": 1}):
        want = np.asarray(jgen.generate_jit(dec, params,
                                            jnp.asarray(prompts), 12, **kw))
        got = tgen.generate(model, prompts, 12, device="cpu", **kw)
        assert got.dtype == torch.int32 and tuple(got.shape) == (3, 21)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
    frozen = tgen.generate(model, prompts, 12, eos_token=eos, pad_token=1,
                           device="cpu").numpy()[0, 9:]
    stop = list(frozen).index(eos)
    assert stop < 11 and (frozen[stop + 1:] == 1).all()
    # max_new 0 answers the prompt; the name the example uses is the same
    # function
    np.testing.assert_array_equal(
        tgen.generate_jit(model, prompts, 0, device="cpu").numpy(), prompts)
    assert tgen.generate_jit is tgen.generate
    with pytest.raises(ValueError, match="max_len"):
        tgen.generate(model, prompts, T, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        tgen.generate(model, prompts, -1, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        tgen.generate(model, prompts, 4, temperature=0.7, device="cpu")


def test_generate_sampled_reproducible_from_seed(lm):
    """temperature > 0 draws from the seeded generator: the same seed
    replays the stream (the reference's PRNG gives other draws)."""
    _, params = lm
    model = _port(params)
    outs = [tgen.generate(model, [[1, 2, 3]], 10, temperature=0.8,
                          top_k=16, device="cpu",
                          generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def _ref_rows(jcache, layer, name):
    return np.asarray(jcache["block_%d" % layer]["attn"][name])


def test_contiguous_slot_primitives_equal_reference(lm):
    """prefill_into_slot into a slot holding stale K/V, then
    decode_step over two rows at different cursors: first tokens,
    logits and every written cache row match the reference's."""
    dec, params = lm
    model = _port(params)
    rng = np.random.RandomState(1)
    p0 = rng.randint(0, V, size=5).astype(np.int32)
    p1 = rng.randint(0, V, size=11).astype(np.int32)
    jc = jgen.init_cache(dec, 2, T)
    tc = tgen.init_cache(model, 2, T, device="cpu")
    assert [sorted(layer) for layer in tc] == \
        [["cache_index", "cached_key", "cached_value"]] * L
    for layer in tc:  # a previous occupant's K/V in both rows
        layer["cached_key"].normal_(generator=torch.Generator()
                                    .manual_seed(2))
    firsts = []
    for slot, prompt, bucket in ((0, p0, 8), (1, p1, 16)):
        toks = np.zeros(bucket, np.int32)
        toks[:len(prompt)] = prompt
        jc, jfirst = jgen.prefill_into_slot(dec, params, jc, slot,
                                            jnp.asarray(toks), len(prompt))
        tfirst = tgen.prefill_into_slot(model, tc, slot, toks, len(prompt))
        assert int(tfirst) == int(jfirst)
        firsts.append(int(tfirst))
    for i in range(L):
        assert tc[i]["cache_index"].tolist() == [5, 11]
        for name in ("cached_key", "cached_value"):
            np.testing.assert_allclose(tc[i][name].numpy(),
                                       _ref_rows(jc, i, name),
                                       atol=FP32_TOL, rtol=0)
    idx = np.array([5, 11], np.int32)
    last = np.array(firsts, np.int32)
    for _ in range(3):
        jc, jt = jgen.decode_step(dec, params, jc, jnp.asarray(last),
                                  jnp.asarray(idx))
        tt = tgen.decode_step(model, tc, last, idx)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        last, idx = tt.numpy(), idx + 1
    # the logits of one more step through the forward itself
    tgen._set_cursor_leaves(tc, idx)
    jcache = jgen._set_cursor_leaves(jc, jnp.asarray(idx))
    jlogits, upd = dec.apply({"params": params, "cache": jcache},
                             jnp.asarray(last)[:, None], mutable=["cache"])
    jc = upd["cache"]
    with torch.no_grad():
        tlogits = model(torch.as_tensor(last)[:, None], tc)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=FP32_TOL, rtol=0)
    assert tc[0]["cache_index"].tolist() == (idx + 1).tolist()
    for i in range(L):
        for name in ("cached_key", "cached_value"):
            np.testing.assert_allclose(
                tc[i][name].numpy()[:, :int(idx.max()) + 1],
                _ref_rows(jc, i, name)[:, :int(idx.max()) + 1],
                atol=FP32_TOL, rtol=0)
    prefill, decode = tgen.slot_step_fns(model)
    assert int(prefill(tc, 0, np.zeros(8, np.int32) + 3, 4)) >= 0
    assert tuple(decode(tc, last, idx).shape) == (2,)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
def test_block_rows_round_trip_as_stored(lm, kv_dtype):
    """gather_block_rows -> scatter_block_rows into another pool is
    bitwise (codes and scales as stored), keyed and ordered as the
    reference's shipment; a dtype or entry mismatch raises."""
    _, params = lm
    model = _port(params)
    a = tgen.init_paged_cache(model, 2, T, kv_blocks=10, block_size=8,
                              kv_dtype=kv_dtype, device="cpu")
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    seq = torch.as_tensor(np.random.RandomState(3).randint(0, V, (1, 40)),
                          dtype=torch.int32)
    with torch.no_grad():
        model(seq, a, torch.zeros(1, dtype=torch.int32), table)
    rows = tgen.gather_block_rows(a, [2, 3, 4])
    names = ["cached_key", "cached_value"] + (
        ["key_scale", "value_scale"] if kv_dtype else [])
    assert [k for k, _ in rows] == sorted(
        "block_%d/attn/%s" % (i, n) for i in range(L) for n in names)
    for key, arr in rows:
        assert arr.shape[0] == 3
        assert str(arr.dtype) == ("float32" if "scale" in key or not kv_dtype
                                  else "int8")
    b = tgen.init_paged_cache(model, 2, T, kv_blocks=10, block_size=8,
                              kv_dtype=kv_dtype, device="cpu")
    tgen.scatter_block_rows(b, [7, 1, 5], rows)
    for i in range(L):
        for n in names:
            assert torch.equal(b[i][n][[7, 1, 5]], a[i][n][[2, 3, 4]])
    with pytest.raises(ValueError, match="lacks pool leaf"):
        tgen.scatter_block_rows(b, [1], rows[1:])
    other = tgen.init_paged_cache(model, 2, T, kv_blocks=10, block_size=8,
                                  kv_dtype=None if kv_dtype else "int8",
                                  device="cpu")
    with pytest.raises(ValueError):
        tgen.scatter_block_rows(other, [1, 2, 3], rows)


def test_draft_is_tied_by_identity(lm):
    """The draft's modules and parameters ARE the target's (never a
    copy), ``draft_params`` aliases the state dict's tensors, and
    non-DecoderLM dicts fail loudly."""
    _, params = lm
    model = _port(params)
    draft = tgen.draft_model(model, 1)
    assert draft.num_layers == 1 and len(draft.blocks) == 1
    assert draft.blocks[0] is model.blocks[0]
    assert draft.pos_embed is model.pos_embed
    for name in ("tok_embed", "ln_f", "head"):
        assert getattr(draft, name) is getattr(model, name)
    target = dict(model.named_parameters())
    for name, p in draft.named_parameters():
        assert p is target[name]
    with pytest.raises(ValueError, match="draft_layers"):
        tgen.draft_model(model, L + 1)
    sd = model.state_dict()
    tied = tgen.draft_params(sd, 1)
    assert set(tied) == {k for k in sd if not k.startswith("blocks.1.")}
    for k, v in tied.items():
        assert v is sd[k]
    with pytest.raises(ValueError, match="blocks.1"):
        tgen.draft_params({"tok_embed.weight": 0, "pos_embed": 0,
                           "ln_f.weight": 0, "head.weight": 0,
                           "blocks.0.x": 0}, 2)

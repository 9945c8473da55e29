"""The port's ``DecoderLM`` (paged decode path) and weight bridge
against the JAX reference.

One flax ``DecoderLM`` is initialised from a seed; ``convert.from_flax``
loads its params into the port's model. The same token calls, made
from a seed with numpy, then run through the JAX model
(``decode=True``, paged, the engine's cursor/table discipline) and the
port on CPU tensors: cold prefill, a mid-sequence prefill over a shared
prefix block, decode steps, and a tail bucket that overshoots
``total_len``. Logits agree within 1e-5 (fp32: only the summation order
of the matmuls and the online softmax differs) and the written K/V
pools within 1e-5; with int8 KV within 1e-4 (a code at a rounding
boundary can land one step apart when the two K/V differ by float
noise).
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

V, H, NH, L, T, BS = 64, 32, 4, 2, 64, 8
P = 12  # usable pool blocks (+1 scratch row)

FP32_TOL = 1e-5
INT8_TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    train = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    p = train.init(jax.random.PRNGKey(3), jnp.zeros((1, T), jnp.int32))
    return jax.tree.map(np.asarray, p["params"])


def _port_model(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    m.load_state_dict(convert.from_flax(params))
    return m.eval()


def test_convert_round_trip_bitwise(params):
    back = convert.to_flax(convert.from_flax(params), NH)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))
        assert flat_b[path].dtype == leaf.dtype
    sd = convert.from_flax(params)
    again = convert.from_flax(back)
    assert list(sd) == list(again)
    for k in sd:
        assert torch.equal(sd[k], again[k]), k
    # and the port model takes it verbatim (no missing/unexpected keys)
    _port_model(params)


def _script(rng):
    """(tokens [B, s], idx [B], tables [B, MB]) calls in engine order."""
    mb = T // BS
    calls = []
    # 1. cold prefill of two rows (bucket 16; row 0's prompt is 13 long,
    #    its pad positions land in its own block 2 past the prompt)
    t1 = np.zeros((2, mb), np.int32)
    t1[0, :2] = [1, 2]
    t1[1, :2] = [3, 4]
    calls.append((rng.randint(0, V, (2, 16)), np.array([0, 0]), t1))
    # 2. mid-sequence prefill on a shared prefix: row 0's first block is
    #    shared, the tail starts at position 8 in fresh blocks 5, 6
    t2 = np.zeros((1, mb), np.int32)
    t2[0, :3] = [1, 5, 6]
    calls.append((rng.randint(0, V, (1, 9)), np.array([8]), t2))
    # 3. three decode steps over both rows at their own depths
    t3 = t1.copy()
    t3[1, 2] = 12  # row 1 crosses into its third block
    for step in range(3):
        calls.append((rng.randint(0, V, (2, 1)),
                      np.array([13 + step, 16 + step]), t3))
    # 4. a tail bucket that overshoots total_len: positions 48..79 with
    #    the table full up to 63; pad rows past it go to scratch
    t4 = np.zeros((1, mb), np.int32)
    t4[0, :] = [1, 2, 7, 8, 9, 10, 11, 5]
    calls.append((rng.randint(0, V, (1, 32)), np.array([48]), t4))
    return calls


def _run_jax(params, calls, kv_dtype):
    model = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T,
                  decode=True, kv_block_size=BS, kv_blocks=P + 1,
                  attn_impl="fused", kv_dtype=kv_dtype)
    outs = []
    cache = jgen.init_cache(model, 2, T)
    for toks, idx, tables in calls:
        b = toks.shape[0]
        # batch-1 calls see the engine-shaped cursor/table leaves cut
        # to one row, as paged_prefill_into_slot does
        view = jax.tree_util.tree_map_with_path(
            lambda path, leaf: leaf[:b] if jgen._leaf_name(path) in
            ("cache_index", "pos_idx", "block_table") else leaf, cache)
        view = jgen._set_paged_leaves(view, jnp.asarray(idx, jnp.int32),
                                      jnp.asarray(tables, jnp.int32))
        logits, upd = model.apply({"params": params, "cache": view},
                                  jnp.asarray(toks, jnp.int32),
                                  mutable=["cache"])
        cache = jax.tree_util.tree_map_with_path(
            lambda path, big, new: big if jgen._leaf_name(path) in
            ("cache_index", "pos_idx", "block_table") else new,
            cache, upd["cache"])
        outs.append(np.asarray(logits))
    pools = [np.asarray(cache["block_%d" % i]["attn"]["cached_key"])
             for i in range(L)]
    return outs, pools


def _run_port(params, calls, kv_dtype, attn_impl="fused"):
    model = _port_model(params)
    cache = tgen.init_paged_cache(model, 2, T, kv_blocks=P, block_size=BS,
                                  kv_dtype=kv_dtype or None, device="cpu")
    outs = []
    with torch.no_grad():
        for toks, idx, tables in calls:
            logits = model(torch.as_tensor(toks, dtype=torch.int32), cache,
                           torch.as_tensor(idx, dtype=torch.int32),
                           torch.as_tensor(tables, dtype=torch.int32),
                           attn_impl=attn_impl)
            outs.append(logits.numpy())
    return outs, [layer["cached_key"].numpy() for layer in cache]


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["fp32", "int8"])
def test_paged_decode_logits_match_jax(params, kv_dtype):
    calls = _script(np.random.RandomState(0))
    want, want_pools = _run_jax(params, calls, kv_dtype)
    got, got_pools = _run_port(params, calls, kv_dtype)
    tol = INT8_TOL if kv_dtype else FP32_TOL
    names = ["cold prefill", "shared-prefix prefill", "decode 1",
             "decode 2", "decode 3", "overshooting tail"]
    for name, g, w in zip(names, got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)
    if not kv_dtype:
        for g, w in zip(got_pools, want_pools):
            # row 0 is scratch: duplicate pad writes land there in an
            # order neither framework defines
            np.testing.assert_allclose(g[1:], w[1:], atol=FP32_TOL,
                                       rtol=FP32_TOL)


def test_gather_formulation_matches_fused(params):
    calls = _script(np.random.RandomState(1))
    fused, _ = _run_port(params, calls, "")
    gather, _ = _run_port(params, calls, "", attn_impl="gather")
    for f, g in zip(fused, gather):
        np.testing.assert_allclose(f, g, atol=FP32_TOL, rtol=FP32_TOL)


def test_layer_norm_and_gelu_follow_flax(params):
    """The three flax defaults torch does not share: LayerNorm eps 1e-6,
    tanh-approximate GELU, and an attention block whose projections
    contract over (heads, head_dim)."""
    m = _port_model(params)
    blk = m.blocks[0]
    assert blk.ln1.eps == blk.ln2.eps == m.ln_f.eps == 1e-6
    x = torch.linspace(-3, 3, 13)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(x, approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), atol=1e-6)
    assert blk.attn.head_dim * blk.attn.num_heads == H

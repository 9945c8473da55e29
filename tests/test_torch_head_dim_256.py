"""Heads 256 wide: the port against the JAX package on the CPU.

The JAX package takes any head dim (its Pallas kernels block only the
sequence). The port's kernels are instantiated at D 256 (flash: float32
and bfloat16; paged: the split-KV decode route and the tensor-core
tiled route, whose launch asks for more than 48 KB of shared memory),
and head dims 129-255 run zero-padded to 256. On the CPU the port takes
its plain versions, so these tests hold them against the JAX package at
the widths the kernels now take, with the same seeded numpy inputs:

- planning: a D-256 paged call refuses a CPU tensor for its device
  only, 129-256 pad to 256, decode at D 256 takes the split route and
  every wider window the tiled one; above 256 (the kernels of
  ``csrc/wide_attention.cu``) both ops at D 320, 512 and 576 against
  the JAX package, and ``tests/test_torch_wide_heads.py`` for the rest;
- paged attention at D 192 and 256, S_q 8 and 40, blocks 16, 32 and 64
  (the tiled route takes any block size), float and int8, through the
  port's plain route against the JAX gather oracle (and, at block 64,
  the Pallas kernel in interpret mode);
- flash forward and gradients (through out and lse) at D 192 and 256,
  S 128, block 128, causal and key-masked, and at D 256 S_q 72 against
  S_k 136 key-masked and causal at S 136 (the edges of the card's
  128-row bfloat16 forward CTAs), against the Pallas kernels
  in interpret mode, within 2e-4 (the D <= 128 cases' tolerance,
  ``tests/test_torch_flash_attention.py``); D 192 also through the
  kernels' padding route (``_on_kernels``) with the plain versions in
  the kernels' place;
- paged attention at D 256, block 16, S_q 1 and 40, float and int8,
  against the JAX gather, blockwise and interpreted Pallas formulations
  within the D <= 128 tolerances (2e-6, int8 8e-6);
- the slice: ``DecoderLM(vocab 64, hidden 512, num_heads 2, layers 2,
  max_len 256)`` (D 256), its flax params carried over by
  ``convert.from_flax`` and back bitwise, full-sequence logits at S 128
  (the flash branch) within 1e-5 (``tests/test_torch_training.py``'s
  limit), one training step's loss within 1e-4 relative and gradients
  within 2e-4 of each parameter's largest, and greedy engine tokens at
  the automatic block (16) identical to the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_attention import TOL as FLASH_TOL
from test_torch_flash_attention import _close, _inputs, _t
from test_torch_paged_attention import FP32_TOL, INT8_TOL, _int8, _jax, _torch

from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu import training as jtraining
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu.ops.flash_attention import (
    flash_attention_lse as jax_flash_lse)
from tensorflowonspark_tpu_torch import convert, serving, training
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.ops import paged_attention as pa

V, H, NH, L, T = 64, 512, 2, 2, 256      # head dim 256
LOGIT_TOL = 1e-5
LOSS_RTOL = 1e-4
#: gradients: max |port - JAX| over max |JAX| per parameter. Both are
#: float32 with only the summation order different (~1e-6 relative per
#: product); the attention key bias's gradient is zero in exact
#: arithmetic, so both sides return rounding noise there, held small
#: against the largest gradient instead
GRAD_RTOL = 2e-4


# -- planning -----------------------------------------------------------


def _paged_inputs(seed, b=3, s_q=1, n=2, d=256, bs=16, mb=4, pool=13):
    """Random pools, per-row tables of distinct pool rows and positions
    ending at each row's own depth (``test_torch_paged_attention._case``
    at the given widths)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s_q, n, d).astype(np.float32)
    kp = rng.randn(pool, bs, n, d).astype(np.float32)
    vp = rng.randn(pool, bs, n, d).astype(np.float32)
    table = np.stack([rng.choice(np.arange(1, pool), size=mb,
                                 replace=False) for _ in range(b)])
    base = rng.randint(0, mb * bs - s_q, size=b)
    pos = base[:, None] + np.arange(s_q)[None, :]
    return q, kp, vp, table.astype(np.int32), pos.astype(np.int32)


@pytest.mark.parametrize("bs", [16, 32])
def test_d256_kernels_are_planned(bs):
    """On CPU tensors the paged kernel at D 256 refuses only for the
    device: the tensor-core tiled kernel's shared memory at D 256
    (147,456 bytes float32, 82,432 int8, whatever the block) fits under
    the card's 227 KB once the launch asks for it through the attribute.
    Flash pads every head of 129-256 to the 256 instantiation, and a
    D-256 decode step takes the split-KV route while its prefill tails
    take the tensor-core tiled one."""
    t = [torch.from_numpy(a) for a in _paged_inputs(0, s_q=8, bs=bs, mb=2)]
    for quant in (False, True):
        assert 48 * 1024 < pa.tiled_smem_bytes(256, quant) <= \
            pa.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="every tensor must be CUDA"):
        pa.paged_attention(*t, impl="kernel")
    assert all(fa.padded_head_dim(d) == 256 for d in range(129, 257))
    assert pa._route(1, 256) == "split"
    assert pa._route(8, 256) == "tiled"


@pytest.mark.parametrize("d", [320, 512, 576])
def test_heads_above_256_match_jax(d):
    """Above 256 both ops run: on the card the kernels of
    ``csrc/wide_attention.cu``, here the plain versions (every CPU
    tensor's route). A D-``d`` paged call refuses a CPU tensor for its
    device alone and plans the wide routes by query count; paged decode
    and a 40-query tail through ``_blockwise`` agree with the JAX gather
    oracle, and the flash pair's out and lse with the Pallas kernels in
    the interpreter, within the D <= 256 tolerances."""
    t = [torch.from_numpy(a)
         for a in _paged_inputs(1, d=d, bs=8, mb=2, pool=5)]
    with pytest.raises(ValueError, match="every tensor must be CUDA"):
        pa.paged_attention(*t, impl="kernel")
    assert (pa._route(1, d), pa._route(3, d), pa._route(40, d)) == (
        "split", "window", "tiled")
    for s_q in (1, 40):
        case = _paged_inputs(20 + d + s_q, s_q=s_q, d=d, bs=16, mb=4)
        np.testing.assert_allclose(_torch(case, impl="blockwise"),
                                   _jax(case, "gather"), atol=FP32_TOL,
                                   rtol=FP32_TOL)
    q, k, v, mask, _, _ = _inputs(2, 64, 64, 2, d, True, d)
    want_out, want_lse = _jax_pair(q, k, v, mask, False)
    got_out, got_lse = fa.flash_attention_lse(
        _t(q), _t(k), _t(v), key_mask=_t(mask), block_q=64, block_k=64)
    _close(got_out, want_out, FLASH_TOL)
    _close(got_lse, want_lse, FLASH_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", pa.SPLIT_HEAD_DIMS)
def test_split_lane_layout_covers_each_dim_once(d, quant):
    """The split kernel's layout of a key row over a warp
    (``SplitShape`` in ``csrc/paged_attention.cu``): LPK lanes share a
    row, each carrying NV 16-byte vectors (NV 2 only for float32 at D
    256). Every dim of the row is held by exactly one lane of a key
    group, each vector is 16-byte aligned, and the lanes of one vector
    index read neighbouring 16 bytes (one coalesced row read)."""
    vec = 16 if quant else 4
    nv = d // vec // 32 if d // vec > 32 else 1
    lpk = d // (vec * nv)
    assert lpk <= 32 and 32 % lpk == 0
    assert nv == (2 if (d == 256 and not quant) else 1)
    dims = [v * lpk * vec + (lane % lpk) * vec + e
            for lane in range(lpk) for v in range(nv) for e in range(vec)]
    assert sorted(dims) == list(range(d))
    for v in range(nv):
        starts = [v * lpk * vec + lane * vec for lane in range(lpk)]
        assert all(s % vec == 0 for s in starts)
        assert np.all(np.diff(starts) == vec)


# -- flash at D 192 and 256 ----------------------------------------------


#: (name, B, S_q, S_k, N, D, causal, masked); the Pallas kernels take
#: blocks of min(128, S) that divide S. The last two are shapes the
#: card's bfloat16 D-256 forward cuts into 128-row CTAs of two 64-row
#: warpgroups and 64-key tiles: S_q 72 against S_k 136 with a key mask
#: (the second warpgroup holds 8 rows, the last key tile 8 keys), and
#: causal at S 136 (a second CTA of 8 rows; causal needs S_q == S_k)
FLASH_WIDE = [
    ("d256_causal", 1, 128, 128, 2, 256, True, False),
    ("d256_key_mask", 2, 128, 128, 2, 256, False, True),
    ("d192_causal", 1, 128, 128, 2, 192, True, False),
    ("d192_key_mask", 2, 128, 128, 2, 192, False, True),
    ("d256_rect_key_mask", 2, 72, 136, 2, 256, False, True),
    ("d256_causal_136", 1, 136, 136, 2, 256, True, False),
]


def _block(s):
    return 128 if s % 128 == 0 else s


def _jax_pair(q, k, v, mask, causal):
    return jax_flash_lse(q, k, v, causal=causal, key_mask=mask,
                         block_q=_block(q.shape[1]), block_k=_block(k.shape[1]),
                         force_pallas=True, interpret=True)


@pytest.mark.parametrize("case", FLASH_WIDE, ids=[c[0] for c in FLASH_WIDE])
def test_flash_wide_heads_match_interpreted_kernels(case):
    """Forward (out, lse) and backward (dq, dk, dv through both outputs,
    a nonzero lse cotangent) of the port's autograd pair against the
    Pallas kernels in the interpreter."""
    _, b, s_q, s_k, n, d, causal, masked = case
    q, k, v, mask, g, g_lse = _inputs(b, s_q, s_k, n, d, masked, d)
    (want_out, want_lse), vjp = jax.vjp(
        lambda q, k, v: _jax_pair(q, k, v, mask, causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out, lse = fa.flash_attention_lse(
        tq, tk, tv, causal=causal,
        key_mask=None if mask is None else _t(mask), block_q=_block(s_q),
        block_k=_block(s_k))
    _close(out, want_out, FLASH_TOL)
    _close(lse, want_lse, FLASH_TOL)
    torch.autograd.backward([out, lse], [_t(g), _t(g_lse)])
    for got, want in zip((tq.grad, tk.grad, tv.grad), want_grads):
        assert torch.isfinite(got).all()
        _close(got, want, FLASH_TOL)
    if masked:  # the last batch row attends to nothing
        assert torch.isneginf(lse[-1]).all() and (out[-1] == 0).all()


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "key_mask"])
def test_flash_d192_through_the_padding_route(causal, masked):
    """D 192 as the card runs it: ``_on_kernels`` zero-pads q, k, v and
    dO to 256 and slices the outputs back, here with the plain versions
    in the kernels' place, taking the scale of the true D. Forward and
    the two backward halves agree with the interpreted Pallas kernels."""
    b, s, n, d = 2, 128, 2, 192
    q, k, v, mask, g, g_lse = _inputs(b, s, s, n, d, masked, 7)
    (want_out, want_lse), vjp = jax.vjp(
        lambda q, k, v: _jax_pair(q, k, v, mask, causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv, tg = _t(q), _t(k), _t(v), _t(g)
    bias = None if mask is None else fa._mask_to_bias(_t(mask))
    scale = d ** -0.5
    seen = []

    def fwd(*a):
        seen.append(a[0].shape[-1])
        return fa._fwd_plain(*a)

    (out, lse), = fa._on_kernels((fwd,), tq, tk, tv, bias, causal, scale)
    assert seen == [256] and out.shape == tq.shape
    _close(out, want_out, FLASH_TOL)
    _close(lse.reshape(b, n, s), want_lse, FLASH_TOL)
    delta = fa._delta(out, tg, _t(g_lse))
    dq, (dk, dv) = fa._on_kernels((fa._dq_plain, fa._dkv_plain), tq, tk, tv,
                                  bias, causal, scale, (tg, lse, delta))
    for got, want in zip((dq, dk, dv), want_grads):
        assert got.shape == tq.shape
        _close(got, want, FLASH_TOL)


# -- paged attention at D 256 ---------------------------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [1, 40], ids=["decode", "tail40"])
@pytest.mark.parametrize("port_impl", ["blockwise", "gather"])
def test_paged_d256_matches_jax_formulations(port_impl, s_q, quant):
    """Block 16, three rows at their own depths, S_q 1 (the split route's
    shape on the card) and 40 (a prefill tail: the tiled route)."""
    tol = INT8_TOL if quant else FP32_TOL
    case = _paged_inputs(11 + s_q, s_q=s_q)
    if quant:
        case = _int8(case)
    got = _torch(case, impl=port_impl)
    for impl, kw in (("gather", {}), ("blockwise", {}),
                     ("pallas", {"interpret": True})):
        np.testing.assert_allclose(got, _jax(case, impl, **kw), atol=tol,
                                   rtol=tol, err_msg="vs JAX " + impl)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("s_q", [8, 40])
@pytest.mark.parametrize("d", [192, 256])
def test_paged_wide_heads_match_jax_at_any_block(d, s_q, bs, quant):
    """The shapes the tiled route now serves at 128 < D <= 256, blocks
    up to 64 (a D-256 engine with ``kv_block_size=64``): three rows at
    their own depths, through the port's plain route (``_blockwise``, the
    kernel's oracle on the card) and its gather oracle, against the JAX
    gather oracle within the D <= 128 tolerances; at block 64, which
    the port's kernels refused at these widths before, also against the
    reference's Pallas kernel in interpret mode."""
    tol = INT8_TOL if quant else FP32_TOL
    case = _paged_inputs(100 + d + s_q + bs, s_q=s_q, d=d, bs=bs,
                         mb=max(2, 160 // bs))
    if quant:
        case = _int8(case)
    want = _jax(case, "gather")
    for impl in ("blockwise", "gather"):
        np.testing.assert_allclose(_torch(case, impl=impl), want, atol=tol,
                                   rtol=tol, err_msg="port " + impl)
    if bs == 64:
        np.testing.assert_allclose(_torch(case, impl="blockwise"),
                                   _jax(case, "pallas", interpret=True),
                                   atol=tol, rtol=tol, err_msg="vs Pallas")


# -- the slice: a DecoderLM with 256-wide heads ----------------------------


@pytest.fixture(scope="module")
def flax_params():
    m = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    p = m.init(jax.random.PRNGKey(19), jnp.zeros((1, T), jnp.int32))
    return jax.tree.map(np.asarray, p["params"])


def _port_model(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    m.load_state_dict(convert.from_flax(params))
    return m


def test_convert_carries_wide_heads_bitwise(flax_params):
    """``convert`` is width-agnostic: the D-256 params go to the port
    and back bit for bit, dtypes kept, and the port takes them with no
    missing or unexpected key."""
    sd = convert.from_flax(flax_params)
    assert sd["blocks.0.attn.query.weight"].shape == (H, H)
    back = convert.to_flax(sd, NH)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(flax_params)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))
        assert flat[path].dtype == leaf.dtype
    assert _port_model(flax_params).blocks[0].attn.head_dim == 256


def test_wide_head_logits_match_reference_at_s128(flax_params):
    """Full-sequence logits at S 128 (the flash branch of both models)."""
    tokens = np.random.RandomState(3).randint(0, V, (2, 128)).astype(
        np.int32)
    jm = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    want = np.asarray(jm.apply({"params": flax_params}, tokens))
    with torch.no_grad():
        got = _port_model(flax_params).eval()(torch.from_numpy(tokens))
    assert got.shape == (2, 128, V)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_wide_head_training_step_matches_reference(flax_params):
    """One step's loss and every parameter's gradient, the flax tree
    carried to the port's names by ``convert.from_flax``."""
    rows = np.random.RandomState(4).randint(0, V, (2, 129)).astype(np.int32)
    batch = {"x": rows[:, :-1], "y": rows[:, 1:]}
    jm = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)

    def loss_fn(p):
        return jtraining.softmax_xent(jm.apply({"params": p}, batch["x"]),
                                      batch)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, flax_params))
    want = convert.from_flax(jax.tree.map(np.asarray, want_grads))
    model = _port_model(flax_params)
    loss = training.softmax_xent(
        model(torch.from_numpy(batch["x"])),
        {"y": torch.from_numpy(batch["y"])})
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    top = max(w.abs().max().item() for w in want.values())
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, w in want.items():
        got = grads[name].grad
        assert got is not None and torch.isfinite(got).all(), name
        if name.endswith("attn.key.bias"):
            assert max(got.abs().max().item(),
                       w.abs().max().item()) <= 1e-4 * top, name
            continue
        err = (got - w).abs().max().item()
        assert err <= GRAD_RTOL * w.abs().max().item(), (name, err)


def test_wide_head_engine_tokens_match_reference(flax_params):
    """Greedy tokens of the paged engines at the automatic block (16:
    the largest divisor of 256 up to 16), 2 slots, mixed prompt lengths
    with a prefill past one block: the port (split-KV decode and
    tensor-core tiled tails on the card; the plain version here) emits the
    JAX engine's tokens exactly."""
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, V, size=int(n)).tolist(), int(m))
            for n, m in ((5, 6), (23, 5), (40, 4), (9, 7))]
    dec = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T,
                decode=True)
    outs = []
    for engine in (jserving.DecodeEngine(dec, flax_params, slots=2),
                   serving.DecodeEngine(_port_model(flax_params), slots=2,
                                        device="cpu")):
        with engine as eng:
            assert eng.kv_block_size == 16
            outs.append([h.result(300) for h in
                         [eng.submit(p, m) for p, m in reqs]])
    want, got = outs
    assert got == want
    assert all(len(g) == len(p) + m for g, (p, m) in zip(got, reqs))

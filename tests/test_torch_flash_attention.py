"""The port's flash attention against the JAX package's Pallas kernels.

The same inputs, made with numpy from a seed, go through the JAX
``flash_attention_lse(..., force_pallas=True, interpret=True)`` (the
Pallas kernels in the interpreter, as ``tests/test_ops.py`` runs them)
and the port's ``flash_attention_lse`` on CPU tensors (its plain
versions inside the ``torch.autograd.Function``). Forward (out, lse)
and backward (dq, dk, dv through both outputs, with a nonzero lse
cotangent) agree within 2e-4, the JAX tests' own tolerance: both are
float32 with only the summation order different. The plain backward is
also held against torch autograd of the plain forward at 1e-5.

The backward kernels multiply on the tensor cores in TF32 with the
3xTF32 split; an emulation of that arithmetic here pins why three
passes (and not one) keep them within the card's float32 limits. The
bfloat16 forward, dQ and dK/dV kernels multiply bfloat16 operands on
``wgmma``: the emulation pins that the forward's products are the
one-pass TF32 products in another order, and why dQ splits dS and dK/dV
P^T and dS^T into bfloat16 hi + lo (one rounding misses the bfloat16
limits).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops.flash_attention import (
    _check_blocks as jax_check_blocks)
from tensorflowonspark_tpu.ops.flash_attention import (
    flash_attention_lse as jax_flash_lse)
from tensorflowonspark_tpu_torch.ops import flash_attention as fa

TOL = 2e-4

#: (name, B, S_q, S_k, N, D, causal, masked, block_q, block_k)
CASES = [
    ("causal", 1, 64, 64, 2, 16, True, False, 32, 16),
    ("key_mask_full_row", 2, 64, 64, 2, 16, False, True, 32, 16),
    ("rectangular", 1, 32, 64, 2, 16, False, False, 16, 32),
    ("causal_key_mask", 2, 32, 32, 1, 32, True, True, 16, 16),
]


def _inputs(b, s_q, s_k, n, d, masked, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s_q, n, d).astype(np.float32)
    k = rng.randn(b, s_k, n, d).astype(np.float32)
    v = rng.randn(b, s_k, n, d).astype(np.float32)
    mask = None
    if masked:
        mask = rng.rand(b, s_k) > 0.3
        mask[:, 0] = True
        mask[-1] = False  # the last batch row attends to nothing
    g = rng.randn(b, s_q, n, d).astype(np.float32)
    g_lse = rng.randn(b, n, s_q).astype(np.float32)
    return q, k, v, mask, g, g_lse


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_interpreted_kernel(case):
    _, b, s_q, s_k, n, d, causal, masked, bq, bk = case
    q, k, v, mask, _, _ = _inputs(b, s_q, s_k, n, d, masked, 0)
    want_out, want_lse = jax_flash_lse(
        q, k, v, causal=causal, key_mask=mask, block_q=bq, block_k=bk,
        force_pallas=True, interpret=True)
    got_out, got_lse = fa.flash_attention_lse(
        _t(q), _t(k), _t(v), causal=causal,
        key_mask=None if mask is None else _t(mask), block_q=bq, block_k=bk)
    _close(got_out, want_out)
    _close(got_lse, want_lse)
    if masked:  # a row with no visible key: out 0, lse -inf
        assert torch.isneginf(got_lse[-1]).all()
        assert (got_out[-1] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_interpreted_kernels(case):
    _, b, s_q, s_k, n, d, causal, masked, bq, bk = case
    q, k, v, mask, g, g_lse = _inputs(b, s_q, s_k, n, d, masked, 1)

    def f(q, k, v):
        return jax_flash_lse(q, k, v, causal=causal, key_mask=mask,
                             block_q=bq, block_k=bk, force_pallas=True,
                             interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out, lse = fa.flash_attention_lse(
        tq, tk, tv, causal=causal,
        key_mask=None if mask is None else _t(mask), block_q=bq, block_k=bk)
    torch.autograd.backward([out, lse], [_t(g), _t(g_lse)])
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.isfinite(got).all()
        _close(got, w)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "key_mask"])
def test_plain_backward_matches_autograd_of_plain_forward(causal, masked):
    """``_bwd_plain``'s FlashAttention-2 formulas equal autograd through
    ``_reference_lse`` (every row keeps a visible key: autograd of a
    logsumexp over an all -inf row is NaN, which the formulas avoid)."""
    b, s, n, d = 2, 48, 2, 16
    q, k, v, mask, g, g_lse = _inputs(b, s, s, n, d, False, 2)
    bias = None
    if masked:
        m = np.random.RandomState(3).rand(b, s) > 0.4
        m[:, 0] = True
        bias = fa._mask_to_bias(_t(m))
    scale = d ** -0.5
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out, lse = fa._reference_lse(tq, tk, tv, causal, scale, bias)
    torch.autograd.backward([out, lse], [_t(g), _t(g_lse)])
    dq, dk, dv = fa._bwd_plain(_t(q), _t(k), _t(v), bias, out.detach(),
                               lse.detach().reshape(b * n, s), _t(g),
                               _t(g_lse), causal, scale)
    for got, want in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad)):
        assert (got - want).abs().max().item() <= 1e-5


def test_function_routes_cpu_tensors_to_plain_versions():
    """On CPU tensors nothing launches; the public pair equals the plain
    forward, and a bad impl or block raises."""
    q, k, v, _, _, _ = _inputs(1, 32, 32, 2, 16, False, 4)
    before = dict(fa.launches)
    out, lse = fa.flash_attention_lse(_t(q), _t(k), _t(v), causal=True)
    want, want_lse = fa._reference_lse(_t(q), _t(k), _t(v), True,
                                       16 ** -0.5)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert fa.launches == before
    for impl in ("pallas", "kernel"):
        with pytest.raises(ValueError, match="impl"):
            fa.flash_attention(_t(q), _t(k), _t(v), impl=impl)
    with pytest.raises(AssertionError, match="causal"):
        fa.flash_attention(_t(q), _t(k)[:, :16], _t(v)[:, :16], causal=True)


@pytest.mark.parametrize("dims", [(64, 64, 48, 48), (64, 32, 32, 24),
                                  (48, 48, 16, 16), (100, 60, 128, 128),
                                  (96, 40, 64, 8)])
def test_check_blocks_matches_reference(dims):
    try:
        want = jax_check_blocks(*dims)
    except AssertionError as e:
        with pytest.raises(AssertionError) as got:
            fa._check_blocks(*dims)
        assert str(got.value) == str(e)
    else:
        assert fa._check_blocks(*dims) == want


def test_mask_to_bias():
    m = torch.tensor([[True, False], [False, False]])
    bias = fa._mask_to_bias(m)
    assert bias.dtype == torch.float32
    assert bias[0, 0] == 0 and torch.isneginf(bias[0, 1])
    assert torch.isneginf(bias[1]).all()
    assert fa._mask_to_bias(None) is None


# -- the backward kernels' tensor-core arithmetic, emulated -------------

#: the card's limit for a float32 kernel against its plain version, as
#: max |kernel - plain| over max(1, max |plain|) (chip_smoke.py)
FLASH_F32_RTOL = 1e-4


def _tf32(x):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds, and as the kernels
    round an operand's hi part: to nearest, ties away from zero, 10 stored
    mantissa bits (the low 13 of the float32 bit pattern cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x):
    """The TF32 value a tensor-core mma reads from a float32 register: the
    low 13 bits ignored (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, a_lo=True, b_lo=True):
    """``a @ b`` as the kernels' ``mma3_rows`` computes it: each operand
    split into ``hi = tf32(x)`` and ``lo = x - hi`` (of which the mma
    reads the TF32 part), the products ``lo.hi`` and ``hi.lo`` summed
    first and ``hi.hi`` last, in float32. ``a_lo``/``b_lo`` False drop a
    pass, as the kernels do at compile time for a bfloat16 operand; both
    False is a single TF32 pass."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if a_lo:
        out = out + _tf32_read(a - ah) @ bh
    if b_lo:
        out = out + ah @ _tf32_read(b - bh)
    return out + ah @ bh


def _bf16_parts(x, parts):
    """``x`` as bfloat16 A operands in the order the dQ and dK/dV kernels
    issue them: ``[hi]`` (one rounding) or ``[lo, hi]`` with ``hi`` = x rounded
    to bfloat16 and ``lo`` the float32 remainder rounded again."""
    hi = x.to(torch.bfloat16).float()
    return [hi] if parts == 1 else [(x - hi).to(torch.bfloat16).float(), hi]


def _emulated_bwd(q, k, v, dout, lse, delta, causal, scale, passes=3,
                  input_lo=True, bias=None, pds_parts=0):
    """dQ, dK, dV (``[B, S, N, D]``) with the kernels' formulas and
    products: ``passes`` 3 is 3xTF32 (``input_lo`` False drops the lo
    parts of q, k, v, dO, as the bfloat16 kernels do; P and dS are always
    split), 1 a single TF32 pass everywhere. ``pds_parts`` 1 or 2 takes
    dQ, dK and dV as the bfloat16 ``wgmma`` kernels do: dS, P^T and dS^T
    rounded to bfloat16 (1) or split into bfloat16 lo and hi (2, lo
    first), each part times the bfloat16 input exact in float32, summed
    in float32. ``bias``: the ``[B, S_k]`` key-mask row."""

    def mm(a, b, a_input, b_input):
        if passes == 1:
            return _mm(a, b, False, False)
        return _mm(a, b, input_lo or not a_input, input_lo or not b_input)

    def mm_parts(a, b):
        out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
        for part in _bf16_parts(a, pds_parts):
            out = out + part @ b
        return out

    b, s_q, n, _ = q.shape
    qf, kf, vf, of = (x.permute(0, 2, 1, 3) for x in (q, k, v, dout))
    s = mm(qf, kf.transpose(-1, -2), True, True) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        s = s.masked_fill(~fa._tril(s_q, k.shape[1], q.device),
                          float("-inf"))
    lse = lse.reshape(b, n, s_q, 1)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                  torch.zeros_like(lse)))
    p = p.masked_fill(torch.isneginf(s), 0.0)
    dp = mm(of, vf.transpose(-1, -2), True, True)
    ds = p * (dp - delta.reshape(b, n, s_q, 1))
    if pds_parts:
        dq = mm_parts(ds, kf) * scale
        dk = mm_parts(ds.transpose(-1, -2), qf) * scale
        dv = mm_parts(p.transpose(-1, -2), of)
    else:
        dq = mm(ds, kf, False, True) * scale
        dk = mm(ds.transpose(-1, -2), qf, False, True) * scale
        dv = mm(p.transpose(-1, -2), of, False, True)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _bwd_case(seed, b=1, s=128, n=2, d=64, round_bf16=False):
    q, k, v, _, g, g_lse = _inputs(b, s, s, n, d, False, seed)
    q, k, v, g = (_t(x) for x in (q, k, v, g))
    if round_bf16:
        q, k, v, g = (x.to(torch.bfloat16).float() for x in (q, k, v, g))
    scale = d ** -0.5
    out, lse = fa._reference_lse(q, k, v, True, scale)
    lse = lse.reshape(b * n, s)
    delta = fa._delta(out, g, _t(g_lse))
    want = (fa._dq_plain(q, k, v, None, g, lse, delta, True, scale),
            *fa._dkv_plain(q, k, v, None, g, lse, delta, True, scale))
    return (q, k, v, g, lse, delta, True, scale), want


def _rel_errors(got, want):
    return [((x - w).abs().max() / max(1.0, w.abs().max().item())).item()
            for x, w in zip(got, want)]


def test_three_tf32_passes_hold_float32_limits_one_does_not():
    """The kernels' 3xTF32 products keep dQ, dK and dV within 1e-5 of
    max |plain| (10x under the card's FLASH_F32_RTOL) at a causal S 128,
    D 64 shape; a single TF32 pass misses FLASH_F32_RTOL, which is why
    the kernels pay for three."""
    args, want = _bwd_case(0)
    for err in _rel_errors(_emulated_bwd(*args, passes=3), want):
        assert err <= 1e-5
    for err in _rel_errors(_emulated_bwd(*args, passes=1), want):
        assert err > FLASH_F32_RTOL


def test_bfloat16_inputs_drop_their_lo_passes_exactly():
    """A bfloat16 value is exact in TF32 (lo = 0), so the kernels' one
    pass for Q K^T and dO V^T and two for the products with P or dS give
    the same bits as all three; the scale multiplies the product, not Q,
    because a scaled bfloat16 Q is not exact in TF32 at D 32 or 128."""
    args, _ = _bwd_case(1, round_bf16=True)
    q = args[0]
    assert torch.equal(_tf32(q), q)
    assert not torch.equal(_tf32(q * 32 ** -0.5), q * 32 ** -0.5)
    for x, y in zip(_emulated_bwd(*args, passes=3),
                    _emulated_bwd(*args, passes=3, input_lo=False)):
        assert torch.equal(x, y)


#: the card's bfloat16 limit for a gradient, element by element:
#: |kernel - plain| <= 2^-7 |plain| + 1e-3 max |plain|
#: (tests/test_torch_cuda_kernel.py, chip_smoke.py)
BF16_RTOL, BF16_FLOOR = 2.0 ** -7, 1e-3


def _bf16_limit_ratio(got, want):
    """max over entries of |got - want| over the bfloat16 limit, both
    rounded to bfloat16 as the kernel and the plain version store them."""
    g, w = got.to(torch.bfloat16).float(), want.float()
    limit = BF16_RTOL * w.abs() + BF16_FLOOR * w.abs().max()
    return ((g - w).abs() / limit).max().item()


def test_dkv_bf16_hi_lo_split_holds_bf16_limits_one_rounding_does_not():
    """The bfloat16 dK/dV kernel feeds P^T and dS^T to ``wgmma`` as
    bfloat16 A operands. Rounded once (FlashAttention-2's choice), dK or
    dV misses the card's bfloat16 limit at a BERT-like shape (B 2, S 384,
    D 64, key mask with a fully masked batch row); split into bfloat16
    hi + lo (two passes, |x - hi - lo| <= 2^-16 |x|) both stay within
    three quarters of it, as far under as two independent roundings of
    float32 results allow. So the kernel pays for the second pass."""
    b, s, n, d = 2, 384, 4, 64
    q, k, v, mask, g, _ = _inputs(b, s, s, n, d, True, 0)
    q, k, v, g = (_t(x).to(torch.bfloat16) for x in (q, k, v, g))
    bias = fa._mask_to_bias(_t(mask))
    scale = d ** -0.5
    out, lse = fa._reference_lse(q, k, v, False, scale, bias)
    lse = lse.reshape(b * n, s)
    delta = fa._delta(out, g)
    want = fa._dkv_plain(q, k, v, bias, g, lse, delta, False, scale)
    args = tuple(x.float() for x in (q, k, v, g)) + (lse, delta, False,
                                                      scale)
    _, *one = _emulated_bwd(*args, bias=bias, pds_parts=1)
    _, *two = _emulated_bwd(*args, bias=bias, pds_parts=2)
    assert max(_bf16_limit_ratio(x, w) for x, w in zip(one, want)) > 1.0
    for x, w in zip(two, want):
        assert torch.isfinite(x).all()
        assert _bf16_limit_ratio(x, w) <= 0.75
    # the fully masked batch row's keys get no gradient
    assert (two[0][-1] == 0).all() and (two[1][-1] == 0).all()


def test_dq_bf16_hi_lo_split_holds_bf16_limits_one_rounding_does_not():
    """The bfloat16 dQ kernel feeds dS to ``wgmma`` as the A operand of
    dS K. At the same BERT-like shape (B 2, S 384, D 64, key mask with a
    fully masked batch row), dS rounded once to bfloat16 misses the
    card's bfloat16 limit on dQ (~1.3x of it at this seed); split into
    bfloat16 hi + lo (two passes, lo first) dQ stays within three
    quarters of it (~0.5x), and the fully masked row's dQ is 0. So dQ
    pays for the second pass as dK/dV does."""
    b, s, n, d = 2, 384, 4, 64
    q, k, v, mask, g, _ = _inputs(b, s, s, n, d, True, 0)
    q, k, v, g = (_t(x).to(torch.bfloat16) for x in (q, k, v, g))
    bias = fa._mask_to_bias(_t(mask))
    scale = d ** -0.5
    out, lse = fa._reference_lse(q, k, v, False, scale, bias)
    lse = lse.reshape(b * n, s)
    delta = fa._delta(out, g)
    want = fa._dq_plain(q, k, v, bias, g, lse, delta, False, scale)
    args = tuple(x.float() for x in (q, k, v, g)) + (lse, delta, False,
                                                      scale)
    one = _emulated_bwd(*args, bias=bias, pds_parts=1)[0]
    two = _emulated_bwd(*args, bias=bias, pds_parts=2)[0]
    assert _bf16_limit_ratio(one, want) > 1.0
    assert torch.isfinite(two).all()
    assert _bf16_limit_ratio(two, want) <= 0.75
    # the fully masked batch row's queries get no gradient
    assert (two[-1] == 0).all()


# -- the forward kernel's tensor-core arithmetic, emulated --------------


def _emulated_fwd(q, k, v, causal, scale, qk_passes=3, pv_passes=3,
                  input_lo=True, bf16_p=False):
    """(out [B, S, N, D], lse [B, N, S]) in the forward kernel's order:
    S = Q K^T on the unscaled Q through ``qk_passes`` TF32 passes (3:
    3xTF32; ``input_lo`` False drops the lo parts of q, k, v, as the
    bfloat16 kernel does), the scale on the float32 S, P = exp(s - m) in
    float32 with l its float32 row sum, P cast to V's dtype (``bf16_p``:
    rounded to bfloat16, whose lo part the kernel drops), then P V
    through ``pv_passes`` passes over l."""

    def mm(a, b, passes, a_lo, b_lo):
        if passes == 1:
            return _mm(a, b, False, False)
        return _mm(a, b, a_lo, b_lo)

    s_q, s_k = q.shape[1], k.shape[1]
    qf, kf, vf = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    s = mm(qf, kf.transpose(-1, -2), qk_passes, input_lo, input_lo) * scale
    if causal:
        s = s.masked_fill(~fa._tril(s_q, s_k, q.device), float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isneginf(m), torch.zeros_like(m), m))
    p = p.masked_fill(torch.isneginf(s), 0.0)
    l = p.sum(-1, keepdim=True)
    if bf16_p:
        p = p.to(torch.bfloat16).float()
    acc = mm(p, vf, pv_passes, not bf16_p, input_lo)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m + torch.log(l_safe))
    return (acc / l_safe).permute(0, 2, 1, 3), lse[..., 0]


def test_forward_three_tf32_passes_hold_float32_limits_one_on_pv_does_not():
    """The forward kernel's 3xTF32 products keep out and lse within 1e-5
    of max |reference| (10x under the card's FLASH_F32_RTOL) of the JAX
    package's interpreted Pallas forward at a causal S 128, D 64 shape;
    a single TF32 pass on P V (with Q K^T still 3xTF32) misses
    FLASH_F32_RTOL on out, which is why the kernel splits P as well."""
    q, k, v, _, _, _ = _inputs(1, 128, 128, 2, 64, False, 5)
    want_out, want_lse = (torch.from_numpy(np.array(x)) for x in jax_flash_lse(
        q, k, v, causal=True, block_q=64, block_k=64, force_pallas=True,
        interpret=True))
    args = (_t(q), _t(k), _t(v), True, 64 ** -0.5)
    out, lse = _emulated_fwd(*args)
    for err in _rel_errors((out, lse), (want_out, want_lse)):
        assert err <= 1e-5
    out, _ = _emulated_fwd(*args, pv_passes=1)
    assert _rel_errors((out,), (want_out,))[0] > FLASH_F32_RTOL


def test_forward_bfloat16_p_and_v_need_one_pass_exactly():
    """With bfloat16 inputs and P rounded to bfloat16 before P V (as the
    kernel casts P to V's dtype), both operands of both products are
    exact in TF32: the kernel's single passes give the same bits as all
    three."""
    q, k, v, _, _, _ = _inputs(2, 96, 96, 2, 32, False, 6)
    q, k, v = (_t(x).to(torch.bfloat16).float() for x in (q, k, v))
    args = (q, k, v, True, 32 ** -0.5)
    out3, lse3 = _emulated_fwd(*args, bf16_p=True)
    out1, lse1 = _emulated_fwd(*args, input_lo=False, bf16_p=True)
    p = torch.rand(64, 64).to(torch.bfloat16).float()
    assert torch.equal(_tf32(p), p)
    assert torch.equal(out1, out3) and torch.equal(lse1, lse3)


def test_forward_bf16_products_equal_one_pass_tf32_up_to_order():
    """The bfloat16 forward multiplies on ``wgmma`` (bfloat16 x bfloat16
    into float32, 16 columns of the contraction per instruction), where
    the earlier kernel took one TF32 pass (``mma`` m16n8k8) on the same
    bfloat16 values. Each product of two bfloat16 values is exact in
    float32 (8 + 8 significant bits), and bfloat16 is exact in TF32, so
    the two give the same terms and differ only in the order of the
    float32 sum: within D 2^-24 sum |q_i k_i|, for Q K^T and for P V with
    P rounded to bfloat16."""
    rng = np.random.RandomState(8)
    for d in (16, 64, 128):
        q = torch.from_numpy(rng.randn(96, d).astype(np.float32))
        k = torch.from_numpy(rng.randn(80, d).astype(np.float32))
        q, k = (x.to(torch.bfloat16).float() for x in (q, k))
        terms = q[:, None, :].double() * k[None, :, :].double()
        assert torch.equal(terms.float().double(), terms)
        tf32 = _mm(q, k.T, False, False)
        wg = torch.zeros(96, 80)
        for c in range(0, d, 16):       # k16 steps, float32 accumulate
            wg = wg + q[:, c:c + 16] @ k[:, c:c + 16].T
        order = d * 2.0 ** -24 * (q.abs() @ k.abs().T)
        assert ((wg - tf32).abs() <= order).all()
        assert torch.equal(_tf32(q), q)
    p = torch.from_numpy(rng.rand(64, 128).astype(np.float32)).to(
        torch.bfloat16).float()
    v = torch.from_numpy(rng.randn(128, 64).astype(np.float32)).to(
        torch.bfloat16).float()
    wg = torch.zeros(64, 64)
    for c in range(0, 128, 16):
        wg = wg + p[:, c:c + 16] @ v[c:c + 16]
    order = 128 * 2.0 ** -24 * (p.abs() @ v.abs())
    assert ((wg - _mm(p, v, False, False)).abs() <= order).all()


# -- head dims the kernels are not instantiated for, and B * N past one
# launch: the kernel route zero-pads D and slices the batch ------------

#: padded against unpadded plain versions: the same products plus zero
#: terms; float32 sums of other lengths may round apart in the last bits
PAD_F32_TOL = 1e-5
#: bfloat16 outputs: one rounding of float32 values that differ in the
#: last bits can land one bfloat16 ulp (2^-7 relative) apart
PAD_BF16_RTOL = 2.0 ** -7


def _pad_inputs(d, causal, masked, dtype, b=2, s=48, n=3, seed=7):
    q, k, v, mask, g, g_lse = _inputs(b, s, s, n, d, masked, seed)
    ts = [_t(x).to(dtype) for x in (q, k, v, g)]
    bias = fa._mask_to_bias(_t(mask)) if masked else None
    out, lse = fa._fwd_plain(ts[0], ts[1], ts[2], bias, causal, d ** -0.5)
    delta = fa._delta(out, ts[3], _t(g_lse))
    return ts, bias, lse, delta


def _pad_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(torch.isneginf(got).numpy(),
                                  torch.isneginf(want).numpy())
    fin = torch.isfinite(want)
    g, w = got.float()[fin], want.float()[fin]
    if got.dtype == torch.bfloat16:
        limit = PAD_BF16_RTOL * w.abs() + 1e-6
    else:
        limit = PAD_F32_TOL * max(1.0, w.abs().max().item())
    assert ((g - w).abs() <= limit).all(), (g - w).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)],
                         ids=["causal", "key_mask", "causal_key_mask"])
@pytest.mark.parametrize("d", [8, 24, 96, 112])
def test_padded_plain_versions_equal_unpadded(d, causal, masked, dtype,
                                             monkeypatch):
    """The kernel route's padding (``_on_kernels``) around the plain
    versions gives what the plain versions give at the true D: out, lse,
    dQ, dK and dV, with the scale of the true D."""
    (q, k, v, dout), bias, lse, delta = _pad_inputs(d, causal, masked,
                                                     dtype)
    scale = d ** -0.5
    seen = []

    def spy(plain):
        def run(*args):
            seen.append(args[0].shape[-1])
            return plain(*args)
        return run

    (out_p, lse_p), = fa._on_kernels((spy(fa._fwd_plain),), q, k, v, bias,
                                     causal, scale)
    out, lse_u = fa._fwd_plain(q, k, v, bias, causal, scale)
    _pad_close(out_p, out)
    _pad_close(lse_p, lse_u)
    pads = []

    def pad(*args, **kwargs):
        pads.append(args[0].shape)
        return torch.nn.functional.pad(*args, **kwargs)

    monkeypatch.setattr(fa, "F", SimpleNamespace(pad=pad))
    dq_p, (dk_p, dv_p) = fa._on_kernels(
        (spy(fa._dq_plain), spy(fa._dkv_plain)), q, k, v, bias, causal,
        scale, (dout, lse, delta))
    assert len(pads) == 4  # q, k, v and dO, once for both kernels
    _pad_close(dq_p, fa._dq_plain(q, k, v, bias, dout, lse, delta, causal,
                                  scale))
    dk, dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    _pad_close(dk_p, dk)
    _pad_close(dv_p, dv)
    assert seen == [fa.padded_head_dim(d)] * 3
    assert fa.padded_head_dim(d) in fa.HEAD_DIMS and fa.padded_head_dim(d) > d
    if masked:  # the fully masked batch row: out and grads zero
        assert (out_p[-1] == 0).all() and (dq_p[-1] == 0).all()


def test_batch_slices_equal_one_launch(monkeypatch):
    """B * N above one launch's grid: the batch goes in slices of whole
    rows (here at most 4 heads a launch: rows 0-1, 2-3, 4), and the
    joined out, lse, dQ, dK and dV equal one call's."""
    d, causal = 16, False
    (q, k, v, dout), bias, lse, delta = _pad_inputs(
        d, causal, True, torch.float32, b=5, n=2)
    scale = d ** -0.5
    res = (dout, lse, delta)
    whole = [fa._fwd_plain(q, k, v, bias, causal, scale),
             fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale),
             fa._dkv_plain(q, k, v, bias, dout, lse, delta, causal, scale)]
    batches = []

    def spy(plain):
        def run(*args):
            assert args[0].shape[0] * args[0].shape[2] <= 4
            batches.append(args[0].shape[0])
            return plain(*args)
        return run

    monkeypatch.setattr(fa, "MAX_BATCH_HEADS", 4)
    sliced = fa._on_kernels((spy(fa._fwd_plain),), q, k, v, bias, causal,
                            scale) + fa._on_kernels(
        (spy(fa._dq_plain), spy(fa._dkv_plain)), q, k, v, bias, causal,
        scale, res)
    assert batches == [2, 2, 1] * 3
    assert torch.equal(sliced[1], whole[1])
    for got, want in zip(sliced[0] + sliced[2], whole[0] + whole[2]):
        assert torch.equal(got, want)


def test_head_dims_above_256_pad_to_the_wide_chunk():
    """Head dims pad to the next instantiation up to 256, and above it to
    the next multiple of ``WIDE_CHUNK`` (the output columns a CTA of the
    wide kernels owns): ``_on_kernels`` runs D 320 at 384 and slices the
    outputs back, equal to the unpadded plain version within the
    padding tests' limit (zero columns add nothing to q k^T)."""
    assert [fa.padded_head_dim(d)
            for d in (1, 16, 17, 64, 65, 128, 129, 192, 256)] == \
        [16, 16, 32, 64, 128, 128, 256, 256, 256]
    assert [fa.padded_head_dim(d) for d in (257, 320, 384, 385, 512, 576,
                                           1024)] == \
        [384, 384, 384, 512, 512, 640, 1024]
    assert all(fa._wide(fa.padded_head_dim(d)) for d in range(257, 1100))
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 1, 320).astype(np.float32))
               for _ in range(3))
    seen = []

    def fwd(*a):
        seen.append(a[0].shape[-1])
        return fa._fwd_plain(*a)

    (out, lse), = fa._on_kernels((fwd,), q, k, v, None, False, 320 ** -0.5)
    assert seen == [384] and out.shape == q.shape
    want_out, want_lse = fa._fwd_plain(q, k, v, None, False, 320 ** -0.5)
    _pad_close(out, want_out)
    _pad_close(lse, want_lse)
    empty = torch.zeros(0, 16, 1, 16)
    with pytest.raises(ValueError, match="B must be positive"):
        fa._on_kernels((fa._fwd_plain,), empty, empty, empty, None, False,
                       0.25)


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors down the kernel route: ``_route`` says "kernel" (but
    for ``impl="plain"``) and each kernel wrapper is its plain version
    behind the contract the CUDA entry points check (an instantiated
    head dim, ``B * N`` within one launch). Returns the head dims each
    stand-in saw."""
    seen = []

    def stand_in(plain):
        def run(q, k, v, bias, *rest):
            assert q.shape[-1] in fa.HEAD_DIMS or fa._wide(q.shape[-1])
            assert q.shape[0] * q.shape[2] <= fa.MAX_BATCH_HEADS
            seen.append(q.shape[-1])
            return plain(q, k, v, bias, *rest)
        return run

    monkeypatch.setattr(fa, "_route", lambda t, impl: (
        "plain" if impl == "plain" else "kernel"))
    monkeypatch.setattr(fa, "_kernel_fwd", stand_in(fa._fwd_plain))
    monkeypatch.setattr(fa, "_kernel_dq", stand_in(fa._dq_plain))
    monkeypatch.setattr(fa, "_kernel_dkv", stand_in(fa._dkv_plain))
    return seen


@pytest.mark.parametrize("d", [12, 96, 320])
def test_kernel_route_pads_through_autograd(kernel_route, d):
    """``flash_attention_lse`` on the kernel route at D 12, 96 and 320
    (padded to 16, 128 and 384 inside) against the plain route: out, lse
    and the gradients through both outputs."""
    q, k, v, mask, g, g_lse = _inputs(2, 32, 32, 2, d, True, 9)
    outs = []
    for impl in (None, "plain"):
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        out, lse = fa.flash_attention_lse(tq, tk, tv, causal=True,
                                          key_mask=_t(mask), impl=impl)
        torch.autograd.backward([out, lse], [_t(g), _t(g_lse)])
        outs.append([out.detach(), lse.detach(), tq.grad, tk.grad, tv.grad])
    assert kernel_route == [fa.padded_head_dim(d)] * 3
    for got, want in zip(*outs):
        _pad_close(got, want)


def test_decoder_head_dim_12_trains_like_the_reference(kernel_route):
    """``DecoderLM(hidden=96, num_heads=8)`` (D 12) at S 128 takes the
    flash route, padded to 16 on the kernel route, and gives the JAX
    package's logits and, over 3 ``adamw`` steps, its losses."""
    import optax
    from jax.sharding import Mesh

    from tensorflowonspark_tpu import training as jtraining
    from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
    from tensorflowonspark_tpu_torch import convert, training
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    vocab, hidden, heads, layers, seq = 64, 96, 8, 2, 128
    rng = np.random.RandomState(12)
    batches = []
    for _ in range(3):
        row = rng.randint(0, vocab, (2, seq + 1)).astype(np.int32)
        batches.append({"x": row[:, :-1], "y": row[:, 1:]})
    jlm = JaxLM(vocab=vocab, hidden=hidden, num_heads=heads,
                num_layers=layers, max_len=seq)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = jtraining.Trainer(jlm, optax.adamw(1e-3), mesh,
                           loss_fn=jtraining.softmax_xent)
    jstate = jt.init(jax.random.PRNGKey(0), batches[0]["x"])
    params = jax.tree.map(np.asarray, jstate["params"])
    model = DecoderLM(vocab, hidden=hidden, num_heads=heads,
                      num_layers=layers, max_len=seq)
    model.load_state_dict(convert.from_flax(params))
    want = np.asarray(jlm.apply({"params": params}, batches[0]["x"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(batches[0]["x"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert kernel_route == [16] * layers
    tt = training.Trainer(model, training.adamw(1e-3), device="cpu")
    tstate = tt.init()
    for batch in batches:
        jstate, jm = jt.step(jstate, batch)
        tstate, tm = tt.step(tstate, batch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-4 * abs(float(jm["loss"]))
    # each step: one forward, dQ and dK/dV per layer, all at 16
    assert kernel_route == [16] * (layers + 3 * 3 * layers)


def test_bert_head_dim_96_matches_the_reference(kernel_route):
    """A BERT config with 2 heads of 96 (padded to 128 on the kernel
    route), a padded tail and holes in the key mask: the QA logits equal
    flax's, and the gradients of the span loss equal jax.grad's."""
    from tensorflowonspark_tpu.models import bert as jbert
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import bert

    jc, tc = jbert.bert_tiny(), bert.bert_tiny()
    for c, dt in ((jc, jnp.float32), (tc, torch.float32)):
        c.dtype, c.hidden_size, c.num_heads, c.dropout_rate = dt, 192, 2, 0.0
    b, s = 4, 32
    rng = np.random.RandomState(96)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[0, 20:] = False
    mask[1, 5:9] = False
    tt = (np.arange(s)[None, :] >= s // 2).astype(np.int32).repeat(b, 0)
    start = rng.randint(0, s, b).astype(np.int32)
    end = rng.randint(0, s, b).astype(np.int32)
    jm = jbert.BertForQuestionAnswering(jc)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), ids, mask, tt)["params"])
    tm = bert.BertForQuestionAnswering(tc)
    tm.load_state_dict(convert.bert_from_flax(params))
    batch = {"start_positions": start, "end_positions": end}

    def jloss(p):
        logits = jm.apply({"params": p}, ids, mask, tt, deterministic=True)
        return jbert.qa_span_loss(logits, batch), logits

    (want_loss, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    tm.train()
    got = tm(*[torch.from_numpy(x) for x in (ids, mask, tt)])
    loss = bert.qa_span_loss(got, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    loss.backward()
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() <= 1e-4 * np.abs(w).max()
    assert abs(loss.item() - float(want_loss)) <= 1e-4 * float(want_loss)
    want_grads = convert.bert_from_flax(jax.tree.map(np.asarray, jgrads))
    grads = dict(tm.named_parameters())
    # 1e-4 of each parameter's largest gradient, over a floor of 1e-6 of
    # the largest of all: the key biases' and the QA head bias's
    # gradients are zero in exact arithmetic (a shift of a whole row's
    # logits) and float32 noise on both sides
    top = max(float(w.abs().max()) for w in want_grads.values())
    for name, w in want_grads.items():
        err = float((grads[name].grad - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-6 * top, name
    assert kernel_route == [128] * (3 * jc.num_layers)

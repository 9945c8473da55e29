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
"""

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

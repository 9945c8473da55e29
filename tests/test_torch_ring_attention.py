"""The port's ring attention (``tensorflowonspark_tpu_torch.parallel
.ring_attention``) against the JAX package's on a ``{"seq": 4}`` mesh of
the virtual CPU devices (Pallas in interpret mode), in process: the
port runs its 4-way ring through ``_ring_lockstep`` (every rank's step
code in one process, the rotation an index), its block engine the flash
kernels' plain versions (CPU tensors). Inputs come from a numpy seed.

Tolerances: both sides compute the same float32 online-softmax merges
over the same blocks, in another summation order — out within 1e-5,
q/k/v gradients within 1e-4 (sums over S of products of unit-scale
values). The P2P ring over real ranks is held against the lockstep in
``tests/test_torch_parallel.py``.
"""

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.parallel import ring_attention as ra

P = 4
B, S, N, D = 1, 64, 2, 16
BLOCK = 8
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def jmesh():
    from tensorflowonspark_tpu.parallel import build_mesh

    return build_mesh({"seq": P}, devices=jax.devices()[:P])


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, N, D).astype(np.float32) for _ in range(4)]


def _jax_ring(jmesh, q, k, v, w, causal, layout):
    """JAX's ring_flash_attention (interpret mode): out and the q/k/v
    gradients of sum(w * out), in global order."""
    from tensorflowonspark_tpu.parallel import ring_attention as jra

    def loss(q, k, v):
        if layout == "zigzag":
            q, k, v = (jra.to_zigzag(t, P) for t in (q, k, v))
        out = jra.ring_flash_attention(q, k, v, jmesh, causal=causal,
                                       block_q=BLOCK, block_k=BLOCK,
                                       interpret=True, layout=layout)
        if layout == "zigzag":
            out = jra.from_zigzag(out, P)
        return (out * w).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring(q, k, v, w, causal, layout, variant="flash"):
    qt, kt, vt = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    args = (qt, kt, vt)
    if layout == "zigzag":
        args = tuple(ra.to_zigzag(t, P) for t in args)
    kw = dict(causal=causal, variant=variant)
    if variant == "flash":
        kw.update(block_q=BLOCK, block_k=BLOCK, layout=layout)
    out = ra._ring_lockstep(*args, P, **kw)
    if layout == "zigzag":
        out = ra.from_zigzag(out, P)
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _close(got, want, tol, what):
    err = np.abs(got - want).max()
    assert err <= tol, "{}: max |port - jax| {:.3g} > {}".format(
        what, err, tol)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_matches_jax(jmesh, causal):
    """Contiguous layout, both causal modes: out and q/k/v gradients (the
    lse merge's cotangent folded into every block's backward)."""
    q, k, v, w = _inputs(3 + causal)
    want_out, want_g = _jax_ring(jmesh, q, k, v, w, causal, "contiguous")
    got_out, got_g = _port_ring(q, k, v, w, causal, "contiguous")
    _close(got_out, want_out, OUT_TOL, "out")
    for name, g, wg in zip("qkv", got_g, want_g):
        _close(g, wg, GRAD_TOL, "d" + name)


def test_zigzag_roundtrip_parity_and_grads_match_jax(jmesh):
    """to_zigzag/from_zigzag invert each other and the reference's; the
    causal zigzag ring matches JAX's in out and gradients (permutation
    undone) and the full-sequence oracle."""
    from tensorflowonspark_tpu.parallel import ring_attention as jra

    q, k, v, w = _inputs(8)
    zz = ra.to_zigzag(torch.tensor(q), P)
    np.testing.assert_array_equal(zz.numpy(),
                                  np.asarray(jra.to_zigzag(q, P)))
    np.testing.assert_array_equal(ra.from_zigzag(zz, P).numpy(), q)
    assert ra.zigzag_order(P) == jra.zigzag_order(P)

    want_out, want_g = _jax_ring(jmesh, q, k, v, w, True, "zigzag")
    got_out, got_g = _port_ring(q, k, v, w, True, "zigzag")
    _close(got_out, want_out, OUT_TOL, "out")
    for name, g, wg in zip("qkv", got_g, want_g):
        _close(g, wg, GRAD_TOL, "d" + name)
    oracle = fa.reference_attention(*(torch.tensor(t) for t in (q, k, v)),
                                    causal=True).numpy()
    _close(got_out, oracle, OUT_TOL, "out vs oracle")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(jmesh, causal):
    """The online-softmax ring (plain torch ops) against JAX's."""
    from tensorflowonspark_tpu.parallel import ring_attention as jra

    q, k, v, _ = _inputs(0)
    want = np.asarray(jra.ring_attention(q, k, v, jmesh, causal=causal))
    got = ra._ring_lockstep(*(torch.tensor(t) for t in (q, k, v)), P,
                            causal=causal, variant="online")
    _close(got.numpy(), want, OUT_TOL, "out")


def test_zigzag_rejects_bad_configs():
    """The reference's three rejections, and the block-divisibility one."""
    q = torch.zeros((1, 8 * 16, 2, 8))
    with pytest.raises(ValueError, match="causal"):
        ra._ring_lockstep(q, q, q, 8, causal=False, layout="zigzag")
    with pytest.raises(ValueError, match="layout"):
        ra._ring_lockstep(q, q, q, 8, causal=True, layout="spiral")
    with pytest.raises(ValueError, match="divisible"):
        ra.to_zigzag(torch.zeros((1, 24, 2, 8)), 8)
    with pytest.raises(ValueError, match="half-block length 8"):
        ra._ring_lockstep(q, q, q, 8, causal=True, layout="zigzag",
                          block_q=16, block_k=16)
    with pytest.raises(ValueError, match="even per-shard"):
        ra._ring_lockstep(torch.zeros((1, 24, 2, 8)), q[:, :24], q[:, :24],
                          8, causal=True, layout="zigzag")


def test_flash_attention_lse_merge_identity():
    """Two disjoint-KV partials merged == attention over the union, as
    the reference's test holds it, on the port's flash_attention_lse."""
    from tensorflowonspark_tpu.parallel import ring_attention as jra

    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(1, 32, 2, 8).astype(np.float32))
               for _ in range(3))
    o1, l1 = fa.flash_attention_lse(q, k[:, :16], v[:, :16], block_q=8,
                                    block_k=8)
    o2, l2 = fa.flash_attention_lse(q, k[:, 16:], v[:, 16:], block_q=8,
                                    block_k=8)
    merged, lse = ra._merge_partials(o1, l1, o2, l2)
    _close(merged.numpy(), fa.reference_attention(q, k, v).numpy(), OUT_TOL,
           "merged")
    jm, jl = jra._merge_partials(o1.numpy(), l1.numpy(), o2.numpy(),
                                 l2.numpy())
    _close(merged.numpy(), np.asarray(jm), 1e-6, "merge vs jax")
    _close(lse.numpy(), np.asarray(jl), 1e-6, "lse vs jax")


def test_merge_of_masked_partials_keeps_grads_finite():
    """A fully masked partial (out 0, lse -inf) merges as the identity,
    and -inf/-inf rows stay inert: no NaN or inf in the forward or the
    backward (torch's logaddexp(-inf, -inf) backward alone gives NaN)."""
    rng = np.random.RandomState(6)
    out_a = torch.tensor(rng.randn(1, 4, 2, 8).astype(np.float32),
                         requires_grad=True)
    lse_a = torch.tensor(rng.randn(1, 2, 4).astype(np.float32))
    lse_a[0, 0, 1] = float("-inf")          # a row masked in both partials
    out_a.data[0, 1, 0] = 0.0
    lse_a.requires_grad_()
    out_b = torch.zeros(1, 4, 2, 8, requires_grad=True)
    lse_b = torch.full((1, 2, 4), float("-inf"), requires_grad=True)
    out, lse = ra._merge_partials(out_a, lse_a, out_b, lse_b)
    fin = torch.isfinite(lse_a.detach())
    assert torch.equal(out.detach(), out_a.detach())
    assert torch.equal(lse.detach()[fin], lse_a.detach()[fin])
    assert torch.isneginf(lse.detach()[0, 0, 1])
    (out.sum() + lse.masked_fill(torch.isneginf(lse), 0.0).sum()).backward()
    for t in (out_a, lse_a, out_b, lse_b):
        assert torch.isfinite(t.grad).all()


def test_one_rank_ring_is_flash_attention():
    """A one-rank contiguous ring launches one partial and rotates
    nothing: it is flash_attention's out, bitwise."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.tensor(rng.randn(1, 32, 2, 16).astype(np.float32))
               for _ in range(3))
    want = fa.flash_attention(q, k, v, causal=True, block_q=8, block_k=8)
    got = ra._ring_lockstep(q, k, v, 1, causal=True, block_q=8, block_k=8)
    assert torch.equal(got, want)

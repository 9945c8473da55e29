"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``cuda`` marker; skips where torch sees no CUDA device):
paged attention, and the three flash-attention kernels (forward, dQ,
dK/dV), with the backward's two-stage copy ring run through many tiles
and a ragged last one, its 32-row tiles at D 128, its determinism (no
atomics) and its register budget at D 64. ``chip_smoke.py`` runs the
same comparisons at the main paths' widths; these are the small-shape
versions for ``pytest -m cuda``."""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.ops import paged_attention as pa

#: same fp32 online softmax on both sides; only summation order differs
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s_q", [1, 8, 40])
def test_kernel_matches_blockwise(cuda, s_q, quant):
    rng = np.random.RandomState(s_q)
    b, n, d, bs, mb = 3, 4, 16, 8, 6
    pool = b * mb + 1
    q = torch.from_numpy(rng.randn(b, s_q, n, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(pool, bs, n, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(pool, bs, n, d).astype(np.float32))
    table = torch.from_numpy(
        (rng.permutation(pool - 1)[:b * mb] + 1).reshape(b, mb)
        .astype(np.int32))
    table[2] = 0  # an inactive slot: all scratch
    depth = torch.tensor([[mb * bs - 3], [mb * bs + 5], [s_q]])
    pos = (depth - s_q + torch.arange(s_q)[None, :]).to(torch.int32)
    scales = {}
    if quant:
        kp, ks = pa.quantize_kv(kp)
        vp, vs = pa.quantize_kv(vp)
        scales = {"k_scale": ks.to(cuda), "v_scale": vs.to(cuda)}
    args = [t.to(cuda) for t in (q, kp, vp, table, pos)]
    before = pa.launches
    got = pa.paged_attention(*args, **scales)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_attention(*args, impl="blockwise", **scales)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


#: flash kernels against their plain versions on the same inputs. lse
#: (float32 in every dtype) and float32 outputs: max |kernel - plain| <=
#: 1e-4 max(1, max |plain|): the forward differs in summation order only,
#: the backward's 3xTF32 tensor-core products are float32-accurate.
#: bfloat16 outputs, element by element, as each side rounds a float32
#: result once (at most one ulp, 2^-7 relative, apart): gradients within
#: 2^-7 |plain| + 1e-3 max |plain| (the floor for order noise where a sum
#: cancels); out within 2^-7 (|plain| + sum_j p_j |v_j|), as both sides
#: also round each P entry to bfloat16 at different scales (2^-8 relative
#: apart at most, a factor 2 under that)
FLASH_F32_RTOL = 1e-4
BF16_RTOL, BF16_FLOOR = 2.0 ** -7, 1e-3

#: (b, s_q, s_k, n, d, causal, masked, dtype)
FLASH_CASES = [
    (2, 80, 80, 2, 16, True, False, torch.float32),      # ragged tiles
    (2, 64, 160, 3, 32, False, True, torch.float32),     # rect + full row
    (2, 128, 128, 2, 64, True, True, torch.bfloat16),
    (1, 72, 72, 1, 128, True, False, torch.float32),
    # the backward's cp.async ring through 9 tiles, the last one ragged
    (1, 520, 520, 2, 64, True, False, torch.bfloat16),
    # D 128: 32-row streamed tiles; rectangular, key mask, ragged S_k
    (2, 256, 200, 2, 128, False, True, torch.float32),
]
FLASH_IDS = ["causal-ragged", "rect-mask", "bf16", "d128",
             "bf16-many-tiles", "d128-rect-mask"]


def _assert_close(got, want, pv=None):
    """``pv``: ``sum_j p_j |v_j|`` where ``got`` is a bfloat16 out."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert fin.any()
    g, w = got.float()[fin], want.float()[fin]
    top = w.abs().max().item()
    if got.dtype == torch.bfloat16 and pv is not None:
        limit = BF16_RTOL * (w.abs() + pv.float()[fin])
    elif got.dtype == torch.bfloat16:
        limit = BF16_RTOL * w.abs() + BF16_FLOOR * top
    else:
        limit = FLASH_F32_RTOL * max(1.0, top)
    assert ((g - w).abs() <= limit).all()


def _flash_inputs(dev, case):
    b, s_q, s_k, n, d, causal, masked, dtype = case
    rng = np.random.RandomState(s_q + d)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype).contiguous()

    q, k, v = t(b, s_q, n, d), t(b, s_k, n, d), t(b, s_k, n, d)
    dout = t(b, s_q, n, d)
    g_lse = torch.from_numpy(rng.randn(b * n, s_q).astype(np.float32)).to(
        dev)
    bias = None
    if masked:
        m = torch.from_numpy(rng.rand(b, s_k) > 0.3)
        m[:, 0] = True
        m[-1] = False  # the last batch row attends to nothing
        bias = fa._mask_to_bias(m.to(dev))
    return q, k, v, dout, g_lse, bias


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_kernels_match_plain(cuda, case):
    b, s_q, s_k, n, d, causal, masked, dtype = case
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = d ** -0.5
    before = dict(fa.launches)
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout, g_lse)
    dq = fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale)
    dk, dv = fa._kernel_dkv(q, k, v, bias, dout, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert fa.launches == {k_: before[k_] + 1 for k_ in before}
    want_out, want_lse = fa._reference_lse(q, k, v, causal, scale, bias)
    want_dq = fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    want_dk, want_dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta,
                                     causal, scale)
    pv, _ = fa._reference_lse(q, k, v.abs(), causal, scale, bias)
    _assert_close(lse, want_lse.reshape(b * n, s_q))
    for got, want, row in ((out, want_out, pv), (dq, want_dq, None),
                           (dk, want_dk, None), (dv, want_dv, None)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        _assert_close(got, want, row)
    if masked:
        assert (out[-1] == 0).all() and (dq[-1] == 0).all()


@pytest.mark.cuda
def test_flash_backward_is_deterministic(cuda):
    """dQ and dK/dV have one writer per output tile and no atomics: two
    launches on the same inputs are bitwise equal."""
    case = (2, 200, 200, 3, 64, True, False, torch.float32)
    q, k, v, dout, g_lse, bias = _flash_inputs(cuda, case)
    scale = 64 ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, True, scale)
    delta = fa._delta(out, dout, g_lse)
    first = (fa._kernel_dq(q, k, v, bias, dout, lse, delta, True, scale),
             *fa._kernel_dkv(q, k, v, bias, dout, lse, delta, True, scale))
    second = (fa._kernel_dq(q, k, v, bias, dout, lse, delta, True, scale),
              *fa._kernel_dkv(q, k, v, bias, dout, lse, delta, True, scale))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_flash_backward_budget_at_d64(cuda, kind, dtype):
    """At the training head dim the backward kernels keep every value in
    registers (no local-memory spills) and fit at least one CTA per SM
    within the card's shared memory."""
    got = fa.bwd_budget(kind, 64, dtype)
    assert got["spill_bytes"] == 0
    assert got["ctas_per_sm"] >= 1
    assert 0 < got["smem_bytes"] <= 227 * 1024

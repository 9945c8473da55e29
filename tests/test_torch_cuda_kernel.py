"""The port's CUDA paged-attention kernel against its plain PyTorch
version, on the card (``cuda`` marker; skips where torch sees no CUDA
device). ``chip_smoke.py`` runs the same comparison at the serving
widths; this is the small-shape version for ``pytest -m cuda``."""

import numpy as np
import pytest
import torch

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

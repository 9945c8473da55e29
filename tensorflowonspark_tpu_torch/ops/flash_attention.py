"""Fused flash attention, forward and backward — the port of
``tensorflowonspark_tpu/ops/flash_attention.py``.

Blocked online-softmax attention that keeps the ``[S, S]`` score matrix
out of device memory, with a FlashAttention-2 backward: dQ (loop over
KV tiles) and dK/dV (loop over Q tiles), both recomputing P from the
saved per-row logsumexp (lse). ``delta = rowsum(dO * O) - g_lse`` is a
torch op between the two halves, as the reference computes it in XLA.

Layout: ``q [B, S_q, N, D]``, ``k``/``v [B, S_k, N, D]``; out
``[B, S_q, N, D]``, lse ``[B, N, S_q]`` at the public functions
(``[B*N, S_q]`` inside). Masking: causal (needs ``S_q == S_k``) and/or
a per-key padding mask ``key_mask [B, S_k]`` bool (True = attend),
carried as an additive 0/-inf float32 bias row. A row that attends to
nothing has out 0 and lse -inf. Rectangular ``S_q != S_k`` is taken
without causal masking.

Two formulations share that contract:

- the **kernels** — hand-written CUDA C++ for Hopper
  (``csrc/flash_attention.cu``), built with ``nvcc`` at first launch and
  bound through ``ctypes``: ``tfos_flash_fwd`` replaces the Pallas
  ``_fwd_kernel``, ``tfos_flash_dq`` ``_dq_kernel``, ``tfos_flash_dkv``
  ``_dkv_kernel``. Bound on the H100: OPERATIONS at the training shape.
  At float32 they run their products on the tensor cores (``mma.sync``
  TF32) with the 3xTF32 split, so they stay float32-accurate (cuBLAS's
  TF32 stays off), and stream their tiles through a two-stage
  ``cp.async`` ring. At bfloat16 all three run on Hopper's ``wgmma``
  with tiles copied by TMA (BERT's path; bound by BYTES there), dS (dQ)
  and P^T, dS^T (dK/dV) split into bfloat16 hi + lo; dQ walks only the
  key tiles its row's mask leaves live. The forward keeps its online
  softmax in registers. The designs are
  in the source's header and the measured share of the bound in
  PERF.md. Head dims 16/32/64/128/256 are instantiated; any other head
  dim up to 256 runs zero-padded to the next of them (zero columns add
  nothing to ``q k^T``, so lse and the true columns are unchanged; a
  192-wide head runs at 256). Above 256 the kernels of
  ``csrc/wide_attention.cu`` take every head dim, zero-padded to a
  multiple of :data:`WIDE_CHUNK`. The forward computes each score once
  per CTA: 8 warps over 32 query rows, the four warps of a row block
  each taking a quarter of the contraction and summing their partial
  scores through shared memory, then each its own :data:`WIDE_CHUNK`
  output columns of a 512-column group (a grid axis above 512), K and V
  streamed through a two-stage ``cp.async`` ring (the source's
  ``fwd_layout``); float32 on ``mma.sync`` TF32 with the 3xTF32
  split, bfloat16 staged as bfloat16 on ``mma.sync`` bf16. dQ and dK/dV
  own one chunk of :data:`WIDE_CHUNK` output columns a CTA and sum the
  scores (and dO V^T) over all of D in 32-column chunks (``mma.sync``
  TF32, 3xTF32 at float32, one pass on bfloat16 operands, which TF32
  holds exactly). A batch whose ``B * N`` exceeds one launch's grid
  runs in slices of the batch (:func:`_on_kernels`). Float32 or
  bfloat16 inputs with float32 statistics and accumulators.
- the **plain versions** — :func:`_reference_lse` (forward),
  :func:`_dq_plain` and :func:`_dkv_plain` (backward, the kernels'
  FlashAttention-2 formulas on the whole score matrix), and
  :func:`reference_attention`, the ``finfo.min``-masked softmax oracle.

:class:`_FlashPair` is the ``torch.autograd.Function`` that reproduces
the reference's ``custom_vjp``: gradients flow through both outputs,
and the lse cotangent folds into delta (``ds = p * (dp - delta +
g_lse)``) with no extra kernel. On a CPU tensor it takes the plain
versions; on a CUDA tensor it launches the kernels or raises — there is
no fallback. ``impl="plain"`` routes a CUDA tensor through the plain
versions on purpose (the oracle a kernel is held against).
"""

import ctypes
import threading

import torch
import torch.nn.functional as F

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128

#: head dims the kernels of ``csrc/flash_attention.cu`` are instantiated
#: for (a template parameter); narrower heads run zero-padded to the next
#: of them
HEAD_DIMS = (16, 32, 64, 128, 256)

#: above ``HEAD_DIMS[-1]`` the kernels of ``csrc/wide_attention.cu`` run
#: at any multiple of this (the output columns one warp of the forward,
#: or one CTA of dQ and dK/dV, owns), a head dim in between zero-padded
#: to the next
WIDE_CHUNK = 128

#: the most ``B * N`` one launch takes (the bfloat16 kernels put it on
#: grid y); a larger batch is launched in slices
MAX_BATCH_HEADS = 65535

#: input dtypes the kernels take (statistics are float32 either way)
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches per kernel, added to only where each is launched —
#: how a run shows that its path went through the kernels
launches = {"fwd": 0, "dq": 0, "dkv": 0}
_launches_lock = threading.Lock()

IMPLS = (None, "plain")


def reference_attention(q, k, v, causal=False, scale=None):
    """Plain full-sequence attention (the correctness oracle): one
    softmax over ``finfo.min``-masked float32 logits."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if causal:
        logits = torch.where(_tril(q.shape[1], k.shape[1], q.device),
                             logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def _tril(s_q, s_k, device):
    return torch.ones((s_q, s_k), dtype=torch.bool, device=device).tril()


def _reference(q, k, v, causal, scale, bias=None):
    if bias is None:
        return reference_attention(q, k, v, causal=causal, scale=scale)
    out, _ = _reference_lse(q, k, v, causal, scale, bias)
    return out


def _scores(q, k, bias, causal, scale):
    """Masked float32 scores ``[B, N, S_q, S_k]``: ``scale q k^T`` plus
    the ``[B, S_k]`` bias row, -inf above the diagonal under causal."""
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        s = s.masked_fill(~_tril(q.shape[1], k.shape[1], q.device),
                          float("-inf"))
    return s


def _reference_lse(q, k, v, causal, scale, bias=None):
    """Plain ``(out, lse [B, N, S_q])`` pair — the kernels' contract,
    with -inf masking (a fully masked row: out 0, lse -inf).

    ``bias``: optional ``[B, S_k]`` additive float32 row (0 / -inf)."""
    logits = _scores(q, k, bias, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)                 # [b, n, q]
    safe = lse.masked_fill(torch.isneginf(lse), 0.0)
    p = torch.exp(logits - safe[..., None]).masked_fill(
        torch.isneginf(logits), 0.0)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype), v)
    return out.to(q.dtype), lse


def _probs(q, k, bias, lse, causal, scale):
    """P recomputed from the saved lse (``[B*N, S_q]``), as the backward
    kernels do: ``exp(s - lse)`` with masked entries 0 and a -inf lse
    read as 0. Returns ``[B, N, S_q, S_k]`` float32."""
    b, s_q, n, _ = q.shape
    s = _scores(q, k, bias, causal, scale)
    lse = lse.reshape(b, n, s_q)
    safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    return torch.exp(s - safe[..., None]).masked_fill(torch.isneginf(s), 0.0)


def _delta(out, dout, g_lse=None):
    """``rowsum(dO * O) - g_lse`` as ``[B*N, S_q]`` float32 — the torch
    op between the forward's residuals and the backward kernels."""
    b, s_q, n, _ = out.shape
    delta = (dout.float() * out.float()).sum(-1)          # [B, S_q, N]
    delta = delta.permute(0, 2, 1).reshape(b * n, s_q)
    if g_lse is not None:
        delta = delta - g_lse.float().reshape(b * n, s_q)
    return delta.contiguous()


def _ds(q, k, v, bias, dout, lse, delta, causal, scale):
    b, s_q, n, _ = q.shape
    p = _probs(q, k, bias, lse, causal, scale)
    dp = torch.einsum("bqnd,bknd->bnqk", dout.float(), v.float())
    return p, p * (dp - delta.reshape(b, n, s_q)[..., None])


def _dq_plain(q, k, v, bias, dout, lse, delta, causal, scale):
    """The dQ kernel's plain version: ``scale * dS K``."""
    _, ds = _ds(q, k, v, bias, dout, lse, delta, causal, scale)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, k.float()) * scale
    return dq.to(q.dtype)


def _dkv_plain(q, k, v, bias, dout, lse, delta, causal, scale):
    """The dK/dV kernel's plain version: ``dS^T (scale Q)`` and
    ``P^T dO``."""
    p, ds = _ds(q, k, v, bias, dout, lse, delta, causal, scale)
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.float() * scale)
    dv = torch.einsum("bnqk,bqnd->bknd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_plain(q, k, v, bias, out, lse, dout, g_lse, causal, scale):
    """Plain backward ``(dq, dk, dv)`` with the kernels' formulas:
    ``delta = rowsum(dO * O) - g_lse``, ``ds = p (dO V^T - delta)``,
    ``dq = scale ds K``, ``dk = ds^T (scale Q)``, ``dv = p^T dO``."""
    delta = _delta(out, dout, g_lse)
    dq = _dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    dk, dv = _dkv_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    return dq, dk, dv


def _check_blocks(s_q, s_k, block_q, block_k):
    """Clamp the blocks to the lengths and require that they divide
    them (the reference's contract; the kernels themselves take any S).
    Raises AssertionError, as the reference's assert does."""
    block_q = min(block_q, s_q)
    block_k = min(block_k, s_k)
    if s_q % block_q or s_k % block_k:
        raise AssertionError(
            "seq lens ({}, {}) must be divisible by block sizes ({}, {})"
            .format(s_q, s_k, block_q, block_k))
    return block_q, block_k


def _mask_to_bias(key_mask):
    """``[B, S_k]`` bool -> ``[B, S_k]`` float32 additive row (True =
    attend)."""
    if key_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
    return torch.where(key_mask.bool(), zero, float("-inf"))


# -- the kernels ---------------------------------------------------------


def _check(cond, msg):
    if not cond:
        raise ValueError("flash_attention kernel: " + msg)


def _check_inputs(q, k, v, bias, causal, extra=()):
    tensors = [q, k, v] + ([bias] if bias is not None else []) + list(extra)
    _check(all(t.is_cuda for t in tensors), "every tensor must be CUDA")
    _check(len({t.device for t in tensors}) == 1,
           "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           "q must be [B, S_q, N, D] and k, v equal [B, S_k, N, D]")
    b, s_q, n, d = q.shape
    s_k = k.shape[1]
    _check(k.shape[0] == b and tuple(k.shape[2:]) == (n, d),
           "k/v batch, heads or head_dim differ from q's")
    _check(q.dtype in DTYPES and k.dtype == v.dtype == q.dtype,
           "q, k, v must share a dtype in {}".format(DTYPES))
    _check(d in HEAD_DIMS or _wide(d),
           "head_dim must be one of {} or a multiple of {} above {}".format(
               HEAD_DIMS, WIDE_CHUNK, HEAD_DIMS[-1]))
    _check(not causal or s_q == s_k, "causal needs equal q/kv lengths")
    _check(bias is None or (bias.dtype == torch.float32
                            and tuple(bias.shape) == (b, s_k)),
           "bias must be float32 [B, S_k]")
    _check(0 < b * n <= MAX_BATCH_HEADS,
           "B * N must be in [1, {}]".format(MAX_BATCH_HEADS))
    _check(s_q > 0 and s_k > 0, "sequence lengths must be positive")
    return b, s_q, s_k, n, d


def _check_aligned(tensors, names):
    _check(all(t.data_ptr() % 16 == 0 for t in tensors),
           names + " must start on a 16-byte boundary (cp.async, TMA)")


def _check_bwd_inputs(q, k, v, bias, dout, lse, delta, causal):
    dims = _check_inputs(q, k, v, bias, causal, (dout, lse, delta))
    b, s_q, _, n, _ = dims
    _check(dout.shape == q.shape and dout.dtype == q.dtype,
           "dO must match q")
    _check(lse.dtype == delta.dtype == torch.float32
           and tuple(lse.shape) == tuple(delta.shape) == (b * n, s_q),
           "lse and delta must be float32 [B*N, S_q]")
    _check_aligned((q, k, v, dout), "q, k, v and dO")
    return dims


def _vp(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _launched(kind, rc):
    if rc != 0:
        raise RuntimeError(
            "flash_attention {} kernel launch failed: CUDA error {}".format(
                kind, rc))
    with _launches_lock:
        launches[kind] += 1


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _wide(d):
    """Whether an (instantiated) head dim ``d`` takes the kernels of
    ``wide_attention.cu``: a multiple of :data:`WIDE_CHUNK` above 256."""
    return d > HEAD_DIMS[-1] and d % WIDE_CHUNK == 0


def _entry(kind, d):
    """The C function that launches kernel ``kind`` at head dim ``d``."""
    from tensorflowonspark_tpu_torch.ops import _build

    if _wide(d):
        return getattr(_build.load("wide_attention"),
                       "tfos_wide_flash_" + kind)
    return getattr(_build.load("flash_attention"), "tfos_flash_" + kind)


def _kernel_fwd(q, k, v, bias, causal, scale):
    """Launch ``tfos_flash_fwd`` (``tfos_wide_flash_fwd`` above 256);
    returns ``(out, lse [B*N, S_q])``."""
    b, s_q, s_k, n, d = _check_inputs(q, k, v, bias, causal)
    _check_aligned((q, k, v), "q, k and v")
    out = torch.empty_like(q)
    lse = torch.empty((b * n, s_q), dtype=torch.float32, device=q.device)
    rc = _entry("fwd", d)(
        _vp(q), _vp(k), _vp(v), _vp(bias), _vp(out), _vp(lse), b, s_q, s_k,
        n, d, int(causal), ctypes.c_float(scale),
        int(q.dtype == torch.bfloat16), _stream(q))
    _launched("fwd", rc)
    return out, lse


def _kernel_dq(q, k, v, bias, dout, lse, delta, causal, scale):
    """Launch ``tfos_flash_dq`` (``tfos_wide_flash_dq`` above 256); returns
    dq in q's dtype."""
    b, s_q, s_k, n, d = _check_bwd_inputs(q, k, v, bias, dout, lse, delta,
                                          causal)
    dq = torch.empty_like(q)
    rc = _entry("dq", d)(
        _vp(q), _vp(k), _vp(v), _vp(bias), _vp(dout), _vp(lse), _vp(delta),
        _vp(dq), b, s_q, s_k, n, d, int(causal), ctypes.c_float(scale),
        int(q.dtype == torch.bfloat16), _stream(q))
    _launched("dq", rc)
    return dq


def _kernel_dkv(q, k, v, bias, dout, lse, delta, causal, scale):
    """Launch ``tfos_flash_dkv`` (``tfos_wide_flash_dkv`` above 256);
    returns (dk, dv) in k's dtype."""
    b, s_q, s_k, n, d = _check_bwd_inputs(q, k, v, bias, dout, lse, delta,
                                          causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _entry("dkv", d)(
        _vp(q), _vp(k), _vp(v), _vp(bias), _vp(dout), _vp(lse), _vp(delta),
        _vp(dk), _vp(dv), b, s_q, s_k, n, d, int(causal),
        ctypes.c_float(scale), int(q.dtype == torch.bfloat16), _stream(q))
    _launched("dkv", rc)
    return dk, dv


#: the kernels :func:`budget` reads, in the C interface's order
BUDGET_KINDS = ("dq", "dkv", "fwd")


def budget(kind, d, dtype):
    """The resources of one kernel instantiation on the current card:
    ``{"ctas_per_sm", "registers", "spill_bytes", "smem_bytes"}`` for
    ``kind`` "fwd", "dq" or "dkv", head dim ``d`` and input ``dtype``
    (registers and local-memory bytes per thread as the compiler left
    them; CTAs per SM from the card's occupancy calculator). Above 256
    (``d`` any multiple of :data:`WIDE_CHUNK`) the wide kernel: dQ and
    dK/dV the same at every such D, the forward with the dynamic shared
    memory it takes at ``d`` (``csrc/wide_attention.cu`` ``fwd_layout``,
    the layout's one source)."""
    from tensorflowonspark_tpu_torch.ops import _build

    _check(kind in BUDGET_KINDS and (d in HEAD_DIMS or _wide(d))
           and dtype in DTYPES,
           "no kernel {} at head_dim {} in {}".format(kind, d, dtype))
    out = (ctypes.c_int * 4)()
    bf16 = int(dtype == torch.bfloat16)
    if _wide(d):
        rc = _build.load("wide_attention").tfos_wide_budget(
            2 + ("fwd", "dq", "dkv").index(kind), bf16, d, out)
    else:
        rc = _build.load("flash_attention").tfos_flash_budget(
            BUDGET_KINDS.index(kind), d, bf16, out)
    if rc != 0:
        raise RuntimeError("flash_attention budget query failed: CUDA error "
                           "{}".format(rc))
    return dict(zip(("ctas_per_sm", "registers", "spill_bytes",
                     "smem_bytes"), out))


# -- dispatch and autograd ----------------------------------------------


def padded_head_dim(d):
    """The instantiated head dim a ``d``-wide head runs at on the
    kernels: the narrowest of :data:`HEAD_DIMS` that holds it, and above
    256 the next multiple of :data:`WIDE_CHUNK`."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    return -(-d // WIDE_CHUNK) * WIDE_CHUNK


def _on_kernels(fns, q, k, v, bias, causal, scale, bwd=()):
    """Call each kernel wrapper of ``fns`` (``_kernel_fwd``, ``_kernel_dq``
    or ``_kernel_dkv``, or a plain version with the same signature) at any
    head dim and any ``B * N``, on inputs padded once for all.

    q, k, v and dO (the first of ``bwd = (dout, lse, delta)``) are
    zero-padded on D to :func:`padded_head_dim`; ``scale`` is the caller's,
    taken from the true D. Zero columns add nothing to ``q k^T``, so lse,
    P and dS are those of the unpadded inputs, and the padded columns of
    out, dQ, dK and dV come out zero and are sliced away. A batch whose
    ``B * N`` exceeds :data:`MAX_BATCH_HEADS` is launched in slices of
    whole batch rows (lse and delta rows ``b * N ...``), joined after.
    Returns a tuple: what each of ``fns`` returns."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp != d:
        q, k, v = (F.pad(t, (0, dp - d)) for t in (q, k, v))
        if bwd:
            bwd = (F.pad(bwd[0], (0, dp - d)),) + tuple(bwd[1:])
    b, n = q.shape[0], q.shape[2]
    _check(b > 0 and 0 < n <= MAX_BATCH_HEADS,
           "B must be positive and N in [1, {}]".format(MAX_BATCH_HEADS))
    per = MAX_BATCH_HEADS // n
    results = []
    for fn in fns:
        parts = []
        for b0 in range(0, b, per):
            rows, heads = slice(b0, b0 + per), slice(b0 * n, (b0 + per) * n)
            extra = () if not bwd else (bwd[0][rows], bwd[1][heads],
                                        bwd[2][heads])
            parts.append(fn(q[rows], k[rows], v[rows],
                            None if bias is None else bias[rows], *extra,
                            causal, scale))
        single = torch.is_tensor(parts[0])
        joined = [torch.cat(ts) if len(ts) > 1 else ts[0]
                  for ts in zip(*[(p,) if single else p for p in parts])]
        joined = [t[..., :d].contiguous() if t.dim() == 4 and dp != d else t
                  for t in joined]
        results.append(joined[0] if single else tuple(joined))
    return tuple(results)


def _route(t, impl):
    """``"kernel"`` or ``"plain"`` for a tensor: None picks the kernel
    for CUDA tensors and the plain versions for CPU tensors."""
    if impl not in IMPLS:
        raise ValueError("unknown flash-attention impl {!r}; expected None "
                         "or 'plain'".format(impl))
    if impl == "plain":
        return impl
    if t.device.type == "cuda":
        return "kernel"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError("flash_attention has no kernel for device {}".format(
        t.device))


def _fwd(q, k, v, bias, causal, scale, impl):
    """``(out, lse [B*N, S_q])`` through the kernel or the plain version."""
    if _route(q, impl) == "kernel":
        return _on_kernels((_kernel_fwd,), q, k, v, bias, causal, scale)[0]
    return _fwd_plain(q, k, v, bias, causal, scale)


def _fwd_plain(q, k, v, bias, causal, scale):
    """The forward kernel's plain version, with its signature and its
    ``(out, lse [B*N, S_q])`` result."""
    b, s_q, n, _ = q.shape
    out, lse = _reference_lse(q, k, v, causal, scale, bias)
    return out, lse.reshape(b * n, s_q)


class _FlashPair(torch.autograd.Function):
    """``(out, lse [B*N, S_q])`` with the FlashAttention-2 backward —
    the reference's ``_flash_pair`` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, impl):
        out, lse = _fwd(q, k, v, bias, causal, scale, impl)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.scale, ctx.impl = causal, scale, impl
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        g = g.contiguous()
        delta = _delta(out, g, g_lse)
        if _route(q, ctx.impl) == "kernel":
            dq, (dk, dv) = _on_kernels((_kernel_dq, _kernel_dkv), q, k, v,
                                       bias, causal, scale, (g, lse, delta))
        else:
            dq = _dq_plain(q, k, v, bias, g, lse, delta, causal, scale)
            dk, dv = _dkv_plain(q, k, v, bias, g, lse, delta, causal, scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_lse(q, k, v, causal=False, scale=None, key_mask=None,
                        block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                        impl=None):
    """Fused attention returning ``(out [B,S,N,D], lse [B,N,S])``.

    Two partials over disjoint KV merge exactly as ``lse =
    logaddexp(lse_a, lse_b)``, ``out = out_a exp(lse_a - lse) + out_b
    exp(lse_b - lse)``. Differentiable in q/k/v, through the lse output
    too. Rows that attend to nothing have lse -inf and out 0.

    ``key_mask``: optional ``[B, S_k]`` bool, True = attend. ``block_q``
    / ``block_k`` must divide the lengths (the reference's contract).
    ``impl``: None (kernels for CUDA tensors, plain versions for CPU
    tensors) or ``"plain"`` (the plain versions on any device)."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    b, s_q, n, _ = q.shape
    s_k = k.shape[1]
    if causal and s_q != s_k:
        raise AssertionError("causal needs equal q/kv lengths")
    _check_blocks(s_q, s_k, block_q, block_k)
    bias = _mask_to_bias(key_mask)
    out, lse = _FlashPair.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bias, bool(causal), scale,
                                impl)
    return out, lse.reshape(b, n, s_q)


def flash_attention(q, k, v, causal=False, scale=None, key_mask=None,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                    impl=None):
    """Fused attention, ``[B, S, N, D]`` in and out: the out half of
    :func:`flash_attention_lse` (the unused lse contributes a zero
    cotangent, folded into delta)."""
    out, _ = flash_attention_lse(q, k, v, causal=causal, scale=scale,
                                 key_mask=key_mask, block_q=block_q,
                                 block_k=block_k, impl=impl)
    return out

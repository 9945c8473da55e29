"""Paged attention through a block table — the port of
``tensorflowonspark_tpu/ops/paged_attention.py``.

K/V live in a shared pool ``[P, block_size, N, D]`` per layer; each
batch row reaches its sequence through a ``block_table`` row. Query
``i`` of row ``b`` sits at logical position ``pos[b, i]`` and attends
every key position ``<= pos[b, i]`` (the caller wrote this call's K/V
through the table first, so the current token sees itself). Layout:
``q [B, S_q, N, D]``, pools ``[P, block_size, N, D]``, ``block_table
[B, MB]`` int32, ``pos [B, S_q]`` int32; returns ``[B, S_q, N, D]``.
int8 pools carry per-head scales ``[P, block_size, N]`` float32 (one
per token row of each block) and are dequantized inside every
formulation.

Three formulations share that contract:

- the **kernels** (:func:`_kernel`) — hand-written CUDA C++ for Hopper
  (``csrc/paged_attention.cu``), built with ``nvcc`` at first launch
  and bound through ``ctypes``. They replace the TPU Pallas kernel
  ``tensorflowonspark_tpu/ops/paged_attention.py::_paged_kernel``
  (wrapper ``_pallas``). Bound on the H100: BYTES at decode — a step
  does ~2 flops per K/V byte it reads, so the floor is the live K/V
  (+ scales) over 3.35 TB/s; OPERATIONS at a prefill tail, whose keys
  are each read by hundreds of queries. Three routes, chosen by the
  call's shape (:func:`_route`):

  - **split-KV** (S_q = :data:`SPLIT_MAX_QUERIES` = 1 at a head dim in
    :data:`SPLIT_HEAD_DIMS`: every decode step): the flash-decoding
    schedule. One CTA per :data:`SPLIT_BLOCKS` consecutive live pool
    blocks of a (row, head), so a decode step of 8 rows x 12 heads still
    spreads over every SM; 16-byte loads of K/V rows straight into
    registers (int8 codes dequantized there), dots reduced across lanes
    by shuffles; each split's partial (m, l, acc) goes to a float32
    workspace allocated here, and a second kernel merges a (row, head)'s
    splits in split order, so the result is deterministic;
  - **tiled** (every other call at head dim <= :data:`TILED_MAX_HEAD_DIM`:
    prefill tails): tensor cores. One CTA of 4 warps per
    :data:`QUERY_TILE`-query tile, the warps splitting the keys; key
    tiles that cross pool blocks stream through a two-stage ``cp.async``
    ring (int8 pools as codes), S = Q K^T and P V run as ``mma.sync``
    TF32 with the 3xTF32 split (2 passes on int8 codes, which are exact
    in TF32, the scales folded into S's and P's columns), float32-
    accurate; :func:`budget` reads its registers and occupancy;
  - **tiled_simt** (head dims above :data:`TILED_MAX_HEAD_DIM`, up to
    :data:`MAX_HEAD_DIM`): the first query-tiled kernel, on CUDA cores,
    one pool block at a time staged in shared memory.

  All walk only a row's LIVE keys through the table (dead slots are
  never loaded, so traffic tracks live tokens, not table width) and
  load int8 pools as int8 (a quarter of the float bytes). The design is
  in the source's header and the measured share of the bound in
  PERF.md.
- :func:`_blockwise` — the same online-softmax recurrence in plain
  PyTorch, one live block per row per iteration; the CPU path and the
  kernel's oracle on the card.
- :func:`_gather` — materialize the logical ``[B, L, N, D]`` view and
  take one softmax over it: the reference oracle (reads every table
  entry, live or not).

On a CPU tensor the dispatcher takes the plain version; on a CUDA
tensor it launches the kernel or raises — there is no fallback.
"""

import threading

import torch

#: calls of :func:`_kernel` that launched (the only place that adds to
#: it) — how a run shows that its path went through the kernels
launches = 0
#: the same calls by route: "split" (two kernel launches a call: the
#: split-KV kernel, then the combine kernel), "tiled" (one launch of the
#: tensor-core query-tiled kernel) or "tiled_simt" (one launch of the
#: CUDA-core query-tiled kernel)
route_launches = {"split": 0, "tiled": 0, "tiled_simt": 0}
_launches_lock = threading.Lock()  # engines launch from their own threads

#: query rows one CTA of either query-tiled kernel handles
#: (csrc/paged_attention.cu ``TC_ROWS``, ``QT``); longer calls go through
#: the grid's query-tile dimension
QUERY_TILE = 16

#: calls with at most this many queries per row take the split-KV
#: route: every decode step (S_q = 1), the only shape the kernel is built
#: for (it holds the row's one query and accumulator in registers)
SPLIT_MAX_QUERIES = 1

#: pool blocks one CTA of the split-KV kernel takes (C): a decode step of
#: 8 rows x 12 heads at depths 32..640 (block 16) has ~400 live CTAs
#: at C = 4, about 3 per SM of the H100's 132, and each of a CTA's 4
#: warps streams one block
SPLIT_BLOCKS = 4

#: head dims the split-KV kernel is instantiated for (a key row splits
#: into a power of two of 16-byte lanes); others take the tiled route
SPLIT_HEAD_DIMS = (16, 32, 64, 128)

#: largest head_dim the tensor-core tiled kernel takes: instantiated at
#: 16, 32, 64 and 128, a head dim in between zero-padded to the next
TILED_MAX_HEAD_DIM = 128

#: largest block_size the kernels take (the CUDA-core tiled kernel scores
#: one key per lane of a warp)
MAX_BLOCK_SIZE = 32

#: largest head_dim the kernels take (the CUDA-core tiled kernel keeps
#: eight accumulator registers per lane per query row)
MAX_HEAD_DIM = 256


def quantize_kv(x):
    """``[..., D]`` float K/V -> ``(codes int8 [..., D], scales float32
    [...])``: symmetric per-head absmax quantization to 127 levels,
    round-half-even (``torch.round`` matches ``jnp.round``). An
    all-zero vector quantizes to zero codes under scale 1.0. Exact
    round trip: requantizing the dequantized grid reproduces codes and
    scales bitwise (the absmax element maps to +-127 exactly)."""
    s = x.abs().amax(dim=-1).to(torch.float32) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(x.to(torch.float32) / s[..., None]),
                    -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q, s):
    """Inverse of :func:`quantize_kv`: ``codes * scales`` in float32."""
    return q.to(torch.float32) * s[..., None].to(torch.float32)


def _nblocks(pos, block_size, table_width):
    """Blocks a row occupies: enough to cover its highest visible
    position, clamped to the table (bucket-padded prefill rows can
    carry ``pos`` past the logical capacity)."""
    return torch.clamp((pos.amax(dim=-1) + block_size) // block_size,
                       max=table_width)


def _gather(q, k_pool, v_pool, block_table, pos, scale, k_scale=None,
            v_scale=None):
    """Materialize the logical ``[B, L, N, D]`` view through the table
    and take one softmax over it (int8 pools dequantize into the view)
    — the reference oracle."""
    b, s, n, d = q.shape
    bs_blk = k_pool.shape[1]
    mb = block_table.shape[1]
    L = mb * bs_blk
    table = block_table.long()
    ck = k_pool[table]
    cv = v_pool[table]
    if k_scale is not None:
        ck = dequantize_kv(ck, k_scale[table])
        cv = dequantize_kv(cv, v_scale[table])
    ck = ck.reshape((b, L) + tuple(ck.shape[3:]))
    cv = cv.reshape((b, L) + tuple(cv.shape[3:]))
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32),
                          ck.to(torch.float32)) * scale
    visible = (torch.arange(L, device=q.device)[None, None, :]
               <= pos[:, :, None])                       # [B, s, L]
    logits = torch.where(visible[:, None, :, :], logits,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(cv.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs, cv)
    return ctx.to(q.dtype)


def _blockwise(q, k_pool, v_pool, block_table, pos, scale, k_scale=None,
               v_scale=None):
    """Online softmax over each row's live blocks in plain PyTorch:
    iteration ``j`` gathers block ``j`` of every row at once and folds
    it into the recurrence; rows whose own depth is ``<= j`` re-read
    their last live block under an all-false mask, which makes their
    update an exact no-op (p = 0, correction = 1). Never reads a pool
    row outside a row's live set."""
    b, s, n, d = q.shape
    bs_blk = k_pool.shape[1]
    mb = block_table.shape[1]
    nblk = _nblocks(pos, bs_blk, mb)                     # [B]
    dev = q.device
    qf = q.to(torch.float32)
    m = torch.full((b, s, n), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, s, n), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, n, d), dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev)
    offs = torch.arange(bs_blk, device=dev)
    trips = int(nblk.max().item()) if b else 0
    for j in range(trips):
        jj = torch.clamp(nblk - 1, max=j)                # [B]
        bid = block_table[rows, jj].long()               # [B]
        kb = k_pool[bid]                                 # [B, bs, N, D]
        vb = v_pool[bid]
        if k_scale is not None:
            kb = dequantize_kv(kb, k_scale[bid])
            vb = dequantize_kv(vb, v_scale[bid])
        sc = torch.einsum("bqnd,btnd->bqnt", qf, kb.to(torch.float32))
        sc = sc * scale                                  # [B, s, N, bs]
        kpos = jj[:, None] * bs_blk + offs[None, :]      # [B, bs]
        vis = (kpos[:, None, :] <= pos[:, :, None]) \
            & (j < nblk)[:, None, None]                  # [B, s, bs]
        sc = torch.where(vis[:, :, None, :], sc,
                         torch.full_like(sc, float("-inf")))
        m_blk = sc.amax(dim=-1)                          # [B, s, N]
        m_new = torch.maximum(m, m_blk)
        safe_m = torch.where(torch.isneginf(m_new),
                             torch.zeros_like(m_new), m_new)
        p = torch.where(torch.isneginf(sc), torch.zeros_like(sc),
                        torch.exp(sc - safe_m[..., None]))
        corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                           torch.exp(m - safe_m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqnt,btnd->bqnd", p, vb.to(torch.float32))
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype)


def _check(cond, msg):
    if not cond:
        raise ValueError("paged_attention kernel: " + msg)


def _route(s_q, head_dim):
    """``"split"``, ``"tiled"`` or ``"tiled_simt"``: the kernel a call
    with ``s_q`` queries per row at ``head_dim`` launches."""
    if s_q <= SPLIT_MAX_QUERIES and head_dim in SPLIT_HEAD_DIMS:
        return "split"
    if head_dim <= TILED_MAX_HEAD_DIM:
        return "tiled"
    return "tiled_simt"


def budget(head_dim, quantized=False):
    """The tensor-core tiled kernel's resources on the current card, for
    the instantiation ``head_dim`` takes and float32 or int8
    (``quantized``) pools: ``{"ctas_per_sm", "registers", "spill_bytes",
    "smem_bytes"}`` (registers and local-memory bytes per thread as the
    compiler left them; CTAs per SM from the card's occupancy
    calculator)."""
    from tensorflowonspark_tpu_torch.ops import _build
    import ctypes

    _check(1 <= head_dim <= TILED_MAX_HEAD_DIM,
           "no tiled kernel at head_dim {}".format(head_dim))
    out = (ctypes.c_int * 4)()
    rc = _build.load("paged_attention").tfos_paged_budget(
        head_dim, int(quantized), out)
    if rc != 0:
        raise RuntimeError("paged_attention budget query failed: CUDA error "
                           "{}".format(rc))
    return dict(zip(("ctas_per_sm", "registers", "spill_bytes",
                     "smem_bytes"), out))


def _kernel(q, k_pool, v_pool, block_table, pos, scale, k_scale=None,
            v_scale=None):
    """Launch ``csrc/paged_attention.cu`` on PyTorch's current stream,
    on the route :func:`_route` picks. Checks everything the kernels do
    not take and raises on it; the output (and the split route's
    workspace) is allocated here. Table entries must be pool rows
    ``0..P-1`` (inactive slots point at the scratch row 0)."""
    global launches
    from tensorflowonspark_tpu_torch.ops import _build
    import ctypes

    quantized = k_scale is not None
    tensors = [q, k_pool, v_pool, block_table, pos] + (
        [k_scale, v_scale] if quantized else [])
    _check(all(t.is_cuda for t in tensors), "every tensor must be CUDA")
    _check(len({t.device for t in tensors}) == 1,
           "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    _check(q.dim() == 4, "q must be [B, S_q, N, D]")
    b, s_q, n, d = q.shape
    _check(q.dtype == torch.float32, "q must be float32")
    _check(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
           "pools must be [P, block_size, N, D] and equal")
    p_rows, bs_blk = k_pool.shape[0], k_pool.shape[1]
    _check(tuple(k_pool.shape[2:]) == (n, d), "pool heads/dim != q's")
    _check(k_pool.dtype == v_pool.dtype == (
        torch.int8 if quantized else torch.float32),
        "pools must be float32, or int8 with scales")
    if quantized:
        _check(k_scale.dtype == v_scale.dtype == torch.float32
               and tuple(k_scale.shape) == (p_rows, bs_blk, n)
               and tuple(v_scale.shape) == (p_rows, bs_blk, n),
               "scales must be float32 [P, block_size, N]")
    _check(block_table.dtype == torch.int32 and block_table.dim() == 2
           and block_table.shape[0] == b, "block_table must be int32 [B, MB]")
    _check(pos.dtype == torch.int32 and tuple(pos.shape) == (b, s_q),
           "pos must be int32 [B, S_q]")
    _check(1 <= bs_blk <= MAX_BLOCK_SIZE,
           "block_size must be in [1, {}]".format(MAX_BLOCK_SIZE))
    _check(1 <= d <= MAX_HEAD_DIM,
           "head_dim must be in [1, {}]".format(MAX_HEAD_DIM))
    route = _route(s_q, d)
    mb = block_table.shape[1]
    if route == "split":
        _check(mb >= 1, "block_table needs at least one column")
        _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
               "pools must start on a 16-byte boundary (16-byte loads)")
    elif route == "tiled_simt":
        _check(2 * bs_blk * (d + 1) * 4 + QUERY_TILE * d * 4 <= 48 * 1024,
               "block_size x head_dim too large for shared memory")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("paged_attention")
    vp = ctypes.c_void_p
    common = (vp(q.data_ptr()), vp(k_pool.data_ptr()), vp(v_pool.data_ptr()),
              vp(k_scale.data_ptr() if quantized else 0),
              vp(v_scale.data_ptr() if quantized else 0),
              vp(block_table.data_ptr()), vp(pos.data_ptr()))
    stream = vp(torch.cuda.current_stream(q.device).cuda_stream)
    if route == "split":
        splits = -(-mb // SPLIT_BLOCKS)
        ws = torch.empty((b, n, splits, d + 2), dtype=torch.float32,
                         device=q.device)
        rc = lib.tfos_paged_attention_split(
            *common, vp(ws.data_ptr()), vp(out.data_ptr()), b, n, d, p_rows,
            bs_blk, mb, SPLIT_BLOCKS, ctypes.c_float(scale), int(quantized),
            stream)
    else:
        launch = (lib.tfos_paged_attention_tiled if route == "tiled"
                  else lib.tfos_paged_attention_simt)
        rc = launch(*common, vp(out.data_ptr()), b, s_q, n, d, p_rows, bs_blk,
                    mb, ctypes.c_float(scale), int(quantized), stream)
    if rc != 0:
        raise RuntimeError(
            "paged_attention {} kernel launch failed: CUDA error {}".format(
                route, rc))
    with _launches_lock:
        launches += 1
        route_launches[route] += 1
    return out


def paged_attention(q, k_pool, v_pool, block_table, pos, scale=None,
                    impl=None, k_scale=None, v_scale=None):
    """Attend ``q`` against paged K/V through ``block_table``.

    ``impl``: None picks the kernels for CUDA tensors and
    :func:`_blockwise` for CPU tensors; ``"kernel"`` forces the kernels
    (CUDA tensors only), ``"blockwise"``/``"gather"`` the plain
    versions on any device. ``k_scale``/``v_scale`` (both or neither)
    mark the pools as int8 codes."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if impl is None:
        impl = "kernel" if q.is_cuda else "blockwise"
    if impl == "kernel":
        return _kernel(q, k_pool, v_pool, block_table, pos, scale,
                       k_scale=k_scale, v_scale=v_scale)
    if impl == "blockwise":
        return _blockwise(q, k_pool, v_pool, block_table, pos, scale,
                          k_scale=k_scale, v_scale=v_scale)
    if impl == "gather":
        return _gather(q, k_pool, v_pool, block_table, pos, scale,
                       k_scale=k_scale, v_scale=v_scale)
    raise ValueError(
        "unknown paged-attention impl {!r}; expected None, 'kernel', "
        "'blockwise' or 'gather'".format(impl))

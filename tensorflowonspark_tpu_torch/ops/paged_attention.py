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
  call's shape (:func:`_route`), at any block size and any head dim (the
  kernels of ``csrc/paged_attention.cu`` up to 256, those of
  ``csrc/wide_attention.cu`` from :data:`WIDE_HEAD_DIM` up):

  - **split-KV** (S_q = :data:`SPLIT_MAX_QUERIES` = 1 at a head dim in
    :data:`SPLIT_HEAD_DIMS`, 16 to 256, or above 256: every decode
    step): the flash-decoding
    schedule. One CTA per :data:`SPLIT_BLOCKS` consecutive live pool
    blocks of a (row, head), so a decode step of 8 rows x 12 heads still
    spreads over every SM; 16-byte loads of K/V rows straight into
    registers (int8 codes dequantized there), dots reduced across lanes
    by shuffles; each split's partial (m, l, acc) goes to a float32
    workspace allocated here, and a second kernel merges a (row, head)'s
    splits in split order, so the result is deterministic. At head dim
    256 a kernel of its own keeps 8 keys in flight a warp and merges in
    the CTA that publishes a (row, head)'s last partial (a ticket from
    :func:`_ticket_ptr`), with no second kernel. Above 256
    (``paged_wide_split_kernel``, CUDA cores) a CTA takes
    :data:`WIDE_SPLIT_KEYS` logical keys of a (row, head) and a
    1024-column chunk of the output, every CTA summing the scores over
    all of D; a combine kernel merges the splits in split order;
  - **window** (2 to :data:`WINDOW_MAX_QUERIES` queries a row at those
    head dims: the speculative verify window): the same schedule, every
    key row read once and dotted with each query of the row, a mask and
    online-softmax state per query, :data:`WINDOW_BLOCKS` pool blocks a
    CTA, the merge folded into the last CTA as at D 256 (above 256 the
    split kernel above, at 2 or 4 queries a row, and its combine);
  - **tiled** (every other call: prefill tails, cold prompts): tensor
    cores. One CTA of 4 warps per
    :data:`QUERY_TILE`-query tile, the warps splitting the keys; key
    tiles that cross pool blocks stream through a two-stage ``cp.async``
    ring (int8 pools as codes), S = Q K^T and P V run as ``mma.sync``
    TF32 with the 3xTF32 split (2 passes on int8 codes, which are exact
    in TF32, the scales folded into S's and P's columns), float32-
    accurate. Instantiated at head dims 16, 32, 64, 128 and 256 (a head
    dim in between zero-padded to the next); at 256 its shared memory
    (:func:`tiled_smem_bytes`) is above 48 KB, granted through the
    kernel's attribute; :func:`budget` reads its registers and
    occupancy. Above 256 (``paged_wide_tiled_kernel``) a CTA of 8 warps
    takes 16 queries and a 512-column group of the output (a grid axis
    above 512) and computes each score once: two key groups of four
    column warps, each warp a quarter of the contraction, the partial
    scores summed through shared memory,
    then each warp its own 128 output columns; key tiles stream through
    the table into a two-stage ``cp.async`` ring (int8 as codes), and
    every column past D is predicated: the pool stays at the model's D
    and is never padded.

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
#: the same calls by route: "split" (two kernel launches a call at D <=
#: 128 and above 256: the split-KV kernel, then the combine kernel; one at
#: D 256, its merge folded in), "window" (one launch, its merge folded in;
#: two above 256) or "tiled" (one launch of the tensor-core query-tiled
#: kernel)
route_launches = {"split": 0, "window": 0, "tiled": 0}
_launches_lock = threading.Lock()  # engines launch from their own threads

#: query rows one CTA of the query-tiled kernel handles
#: (csrc/paged_attention.cu ``TC_ROWS``); longer calls go through the
#: grid's query-tile dimension
QUERY_TILE = 16

#: calls with at most this many queries per row take the split-KV
#: route: every decode step (S_q = 1), the only shape the kernel is built
#: for (it holds the row's one query and accumulator in registers)
SPLIT_MAX_QUERIES = 1

#: calls with 2 to this many queries per row take the window route (the
#: speculative verify window) at a head dim in :data:`SPLIT_HEAD_DIMS`;
#: wider calls the tiled one. The window kernel is instantiated for 2
#: and 4 queries (3 runs the 4 with a masked pad query). 4 is where it
#: stops beating the tiled kernel on the H100 at every width and dtype
#: (``profile_paged.py --crossover``; PERF.md): its cost grows with the
#: queries a row, the tiled kernel's does not up to its 16-row tile.
#: Prefill buckets start at 8, so only verify windows take it.
WINDOW_MAX_QUERIES = 4

#: pool blocks one CTA of the window kernel takes: at the verify window
#: (8 slots x 12 heads at depths 32..640) 8 puts its CTAs in one wave
WINDOW_BLOCKS = 8

#: pool blocks one CTA of the split-KV kernel takes (C): a decode step of
#: 8 rows x 12 heads at depths 32..640 (block 16) has ~400 live CTAs
#: at C = 4, about 3 per SM of the H100's 132, and each of a CTA's 4
#: warps streams one block
SPLIT_BLOCKS = 4

#: head dims the split-KV kernel is instantiated for (a key row splits
#: into a power of two of 16-byte lanes; a float32 row of 256 puts two
#: 16-byte vectors on each lane of the warp); others up to 256 take the
#: tiled route (instantiated at 16, 32, 64, 128 and 256, a head dim in
#: between zero-padded to the next)
SPLIT_HEAD_DIMS = (16, 32, 64, 128, 256)

#: head dims from this one up take the kernels of
#: ``csrc/wide_attention.cu``, on every route: split and window by
#: ``paged_wide_split_kernel`` + ``paged_wide_combine_kernel``, tiled by
#: ``paged_wide_tiled_kernel``. They take any D (columns past D are
#: predicated, loads are one element wide, so rows need no alignment)
WIDE_HEAD_DIM = 257

#: logical keys one CTA of the wide split kernel takes (a split): a call
#: has ceil(table width x block size / this) splits a (row, head), those
#: past a row's live keys writing an empty partial
WIDE_SPLIT_KEYS = 256


#: the most shared memory one CTA may have on the H100 (227 KB)
MAX_SMEM_BYTES = 232448

#: int32 merge tickets per card: the window route and split-KV decode at
#: D 256 merge a (row, head)'s splits in the CTA that publishes the last
#: of them, found by counting on a ticket. Each call takes B x N tickets,
#: the next ones in turn (wrapping around), all at 0, and leaves them at
#: 0; so calls in flight at once — on two engines' streams, or replayed
#: from a CUDA graph — never share one unless a million tickets' worth of
#: calls is in flight
TICKETS = 1 << 20
_tickets = {}  # card index -> [tickets tensor, next free offset]


def _ticket_ptr(device, items):
    """Address of ``items`` zeroed merge tickets on ``device``'s card for
    one call (:data:`TICKETS`). The card's tickets are allocated, zeroed,
    at its first such call, which must not be inside a CUDA-graph
    capture."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    _check(items <= TICKETS, "{} merge tickets in one call".format(items))
    with _launches_lock:
        entry = _tickets.get(index)
        if entry is None:
            _check(not torch.cuda.is_current_stream_capturing(),
                   "the first call on a card allocates its merge tickets "
                   "and must run outside CUDA-graph capture")
            entry = _tickets[index] = [
                torch.zeros(TICKETS, dtype=torch.int32, device=device), 0]
        buf, at = entry
        if at + items > TICKETS:
            at = 0
        entry[1] = at + items
    return buf.data_ptr() + 4 * at


def tiled_smem_bytes(head_dim, quantized=False):
    """Shared memory of one tiled launch at the instantiation ``head_dim``
    takes, up to 256 (``csrc/paged_attention.cu`` ``tc_smem``, dynamic):
    the 16-row float32 Q tile, then the ring — two stages of K and V key
    tiles (64 keys, 32 at 128 and 256; float32 rows, or int8 rows of
    codes and 16 pad bytes with a float32 scale each) — whose space the
    4 warps' (m, l, acc) reuse for the final merge. Above 256 the wide
    tiled kernel's layout is the source's own (``paged_layout``), which
    :func:`budget` reads on the card."""
    _check(1 <= head_dim < WIDE_HEAD_DIM,
           "tiled_smem_bytes covers head dims 1-256, not {}; above, "
           "budget() reads the wide kernel's".format(head_dim))
    dp = next(x for x in (16, 32, 64, 128, 256) if head_dim <= x)
    keys = 32 if dp > 64 else 64
    row = dp + 16 if quantized else 4 * dp
    ring = 4 * keys * row + (4 * keys * 4 if quantized else 0)
    merge = 4 * QUERY_TILE * (dp + 2) * 4
    return QUERY_TILE * dp * 4 + max(ring, merge)


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


def _wide(head_dim):
    """Whether ``head_dim`` takes the kernels of ``wide_attention.cu``."""
    return head_dim >= WIDE_HEAD_DIM


def _route(s_q, head_dim):
    """``"split"``, ``"window"`` or ``"tiled"``: the kernel a call with
    ``s_q`` queries per row at ``head_dim`` launches (above 256, the wide
    kernels of that route)."""
    if head_dim in SPLIT_HEAD_DIMS or _wide(head_dim):
        if s_q <= SPLIT_MAX_QUERIES:
            return "split"
        if s_q <= WINDOW_MAX_QUERIES:
            return "window"
    return "tiled"


#: the routes :func:`budget` reads, in the C interface's order
BUDGET_ROUTES = ("tiled", "split", "window")
#: ``tfos_wide_budget``'s kernel index of each route above 256 (the
#: window route runs the split kernel at 2 or 4 queries a row)
WIDE_BUDGET_KERNELS = {"tiled": 0, "split": 1, "window": 1}


def budget(head_dim, quantized=False, route="tiled", queries=None):
    """One route's kernel resources on the current card, for the
    instantiation ``head_dim`` takes and float32 or int8 (``quantized``)
    pools: ``{"ctas_per_sm", "registers", "spill_bytes", "smem_bytes"}``
    (registers and local-memory bytes per thread as the compiler left
    them; CTAs per SM from the card's occupancy calculator). ``route``
    "tiled" (the default: the tensor-core tiled kernel, dynamic shared
    bytes), "split" (the split-KV kernel, static shared bytes) or
    "window" (the window kernel's instantiation for ``queries`` queries a
    row, default :data:`WINDOW_MAX_QUERIES`; static and dynamic shared
    bytes). Above 256 the route's wide kernel: the split kernel (at 1
    query a row for "split"; static shared bytes) the same at every D,
    the tiled kernel with the shared memory it takes at ``head_dim``
    (the source's ``paged_layout``)."""
    from tensorflowonspark_tpu_torch.ops import _build
    import ctypes

    _check(route in BUDGET_ROUTES, "no route {!r}".format(route))
    if route == "tiled":
        _check(head_dim >= 1,
               "no tiled kernel at head_dim {}".format(head_dim))
    else:
        _check(head_dim in SPLIT_HEAD_DIMS or _wide(head_dim),
               "no {} kernel at head_dim {}".format(route, head_dim))
    queries = WINDOW_MAX_QUERIES if queries is None else int(queries)
    if route == "window":
        _check(2 <= queries <= WINDOW_MAX_QUERIES,
               "no window kernel for {} queries".format(queries))
    out = (ctypes.c_int * 4)()
    if _wide(head_dim):
        rc = _build.load("wide_attention").tfos_wide_budget(
            WIDE_BUDGET_KERNELS[route], int(quantized),
            head_dim if route == "tiled"
            else queries if route == "window" else 1, out)
    else:
        rc = _build.load("paged_attention").tfos_paged_budget(
            BUDGET_ROUTES.index(route), head_dim, int(quantized), queries,
            out)
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
    _check(bs_blk >= 1, "block_size must be at least 1")
    _check(d >= 1, "head_dim must be at least 1")
    route = _route(s_q, d)
    mb = block_table.shape[1]
    wide = _wide(d)
    if wide or route in ("split", "window"):
        _check(mb >= 1, "block_table needs at least one column")
    if not wide and route in ("split", "window"):
        _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
               "pools must start on a 16-byte boundary (16-byte loads)")
    _check(all(t.is_cuda for t in tensors), "every tensor must be CUDA")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = None if wide else _build.load("paged_attention")
    vp = ctypes.c_void_p
    common = (vp(q.data_ptr()), vp(k_pool.data_ptr()), vp(v_pool.data_ptr()),
              vp(k_scale.data_ptr() if quantized else 0),
              vp(v_scale.data_ptr() if quantized else 0),
              vp(block_table.data_ptr()), vp(pos.data_ptr()))
    stream = vp(torch.cuda.current_stream(q.device).cuda_stream)
    if wide and route in ("split", "window"):
        splits = -(-mb * bs_blk // WIDE_SPLIT_KEYS)
        ws = torch.empty((b, n, s_q, splits, d + 2), dtype=torch.float32,
                         device=q.device)
        rc = _build.load("wide_attention").tfos_wide_paged_split(
            *common, vp(ws.data_ptr()), vp(out.data_ptr()), b, s_q, n, d,
            bs_blk, mb, splits, ctypes.c_float(scale), int(quantized),
            stream)
    elif wide:
        rc = _build.load("wide_attention").tfos_wide_paged_tiled(
            *common, vp(out.data_ptr()), b, s_q, n, d, bs_blk, mb,
            ctypes.c_float(scale), int(quantized), stream)
    elif route == "split":
        splits = -(-mb // SPLIT_BLOCKS)
        ws = torch.empty((b, n, splits, d + 2), dtype=torch.float32,
                         device=q.device)
        tickets = _ticket_ptr(q.device, b * n) if d == 256 else 0
        rc = lib.tfos_paged_attention_split(
            *common, vp(ws.data_ptr()), vp(out.data_ptr()), vp(tickets), b,
            n, d, p_rows, bs_blk, mb, SPLIT_BLOCKS, ctypes.c_float(scale),
            int(quantized), stream)
    elif route == "window":
        splits = -(-mb // WINDOW_BLOCKS)
        ws = torch.empty((b, n, s_q, splits, d + 2), dtype=torch.float32,
                         device=q.device)
        rc = lib.tfos_paged_attention_window(
            *common, vp(ws.data_ptr()), vp(out.data_ptr()),
            vp(_ticket_ptr(q.device, b * n)), b, s_q, n, d, p_rows, bs_blk,
            mb, WINDOW_BLOCKS, ctypes.c_float(scale), int(quantized), stream)
    else:
        rc = lib.tfos_paged_attention_tiled(
            *common, vp(out.data_ptr()), b, s_q, n, d, p_rows, bs_blk, mb,
            ctypes.c_float(scale), int(quantized), stream)
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

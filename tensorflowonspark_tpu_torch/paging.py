"""Block-granular KV cache accounting: free-list allocator + prefix cache.

The port's own copy of ``tensorflowonspark_tpu/paging.py`` (numpy
only; the port imports nothing of the JAX package). The HOST half of
the paged KV cache. The device half lives in models/decoder.py and
generation.py (a ``[num_blocks + 1, block_size, heads, dim]`` K/V pool
per attention layer, reached through per-slot block tables); this
module owns which block holds what:

- **free-list allocation** — blocks are fixed-size; a sequence consumes
  ``ceil(len / block_size)`` of them as it grows instead of reserving a
  contiguous ``max_len`` region up front (the PagedAttention insight:
  KV fragmentation drops to at most one partial block per sequence, so
  memory — not compute — stops capping concurrency).
- **ref-counted prefix sharing** — full blocks of a sequence are
  registered under their token chain (the key for block ``j`` is the
  EXACT token tuple ``sequence[:(j+1)*block_size]``, so a hit
  guarantees the whole prefix matches — content-addressed, no hash
  collisions to reason about). A later request whose prompt starts
  with the same tokens points its block table at the shared blocks and
  prefills only the tail. Shared blocks are read-only by construction:
  only COMPLETE blocks are ever shared, and a sharer's write cursor
  starts at the first position past them — so "copy-on-write on the
  first divergent block" degenerates to allocating a fresh private
  block (there is nothing to copy; divergent content simply prefills
  into it). Registrations carry an ``origin`` ("prompt" at admission,
  "generated" when the engine publishes a block DECODE filled),
  so multi-turn reuse — a follow-up turn whose prompt IS the
  prior turn's prompt + reply — is separately countable from repeated
  system prompts.
- **LRU retention** — a released block that is registered in the prefix
  cache is RETAINED (refcount 0, evictable) rather than freed, so the
  next same-prefix request still hits; under allocation pressure the
  least-recently-released cached blocks are evicted back into
  circulation. ``allocatable()`` counts both (free + evictable): it is
  the number the admission gate and the ``kv_blocks_free`` gauge read.

Block id 0 is the SCRATCH block: never allocated, parked in every
unused block-table entry. Prefill pads prompts to a shape bucket, and
the pad positions' K/V writes land through the table — scratch absorbs
them. Its content is garbage by design and is never visible (attention
masks every position past a row's cursor). The device pool therefore
carries ``num_blocks + 1`` rows for a pool of ``num_blocks`` usable
blocks.

Single-writer convention: the engine's scheduler thread is the only
mutator. The internal lock exists so observers (``load_stats``,
``/healthz``, admission estimates on client threads) can read
consistent counts, not to support concurrent mutation.
"""

import collections
import hashlib
import threading

import numpy as np


#: bytes per stored K/V element by pool dtype (bfloat16 has no numpy
#: dtype, so an explicit table beats np.dtype here)
_KV_ITEMSIZE = {"int8": 1, "float16": 2, "bfloat16": 2, "float32": 4,
                "float64": 8}

#: default chain budget of :meth:`BlockPool.prefix_digest` — the
#: BOUNDED part of the fleet's prefix-warmth signal. A beat payload
#: must stay small at any pool size, so a pool with thousands of
#: registered chains still publishes at most this many (the hottest),
#: with ``truncated`` flagging what was cut.
PREFIX_DIGEST_TOP_K = 32

#: hex chars of the truncated chain hash a digest entry carries: 16
#: hex = 64 bits, so accidental collisions across a fleet's worth of
#: resident chains are negligible while the entry stays compact
_DIGEST_HASH_HEX = 16


def chain_digest(tokens, n_tokens):
    """Truncated stable hash of the EXACT chain key ``tokens[:n_tokens]``
    — the wire form of a prefix chain in the beat-carried digest. Both
    sides of the fleet's warmth matching use this one function (the
    pool when publishing, the router when probing a prompt's chain
    prefixes against a replica's digest), so the two can never drift.
    Canonical serialization is the comma-joined decimal token ids:
    content-addressed like the registry itself, independent of process,
    platform, and hash seed (sha1, not ``hash()``)."""
    key = ",".join(str(int(t)) for t in list(tokens)[:int(n_tokens)])
    return hashlib.sha1(key.encode("ascii")).hexdigest()[:_DIGEST_HASH_HEX]


class PoolExhausted(RuntimeError):
    """``alloc`` could not supply the requested blocks even after
    evicting every unreferenced cached block. The engine's scheduler
    preempts or defers admission instead of letting this escape."""


class BlockPool(object):
    """Free-list allocator over ``num_blocks`` usable KV blocks of
    ``block_size`` tokens each (ids ``1..num_blocks``; id 0 is the
    scratch block pad writes land in — see module docstring).

    ``hits``/``misses`` count prefix-cache outcomes at BLOCK
    granularity (a request with 12 shareable full blocks that finds 8
    resident scores 8 hits + 4 misses); ``evictions`` counts cached
    blocks reclaimed by the LRU under allocation pressure.
    """

    def __init__(self, num_blocks, block_size, kv_dtype="float32"):
        if int(num_blocks) < 1:
            raise ValueError(
                "num_blocks must be >= 1, got {}".format(num_blocks))
        if int(block_size) < 1:
            raise ValueError(
                "block_size must be >= 1, got {}".format(block_size))
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        #: storage dtype of the device pools this allocator governs:
        #: "int8" means each block additionally carries
        #: per-head float32 scales per token row — :meth:`block_bytes`
        #: is the byte accounting, :meth:`quantize` the host reference
        #: of the write-path formulation. The allocator's BLOCK math
        #: (blocks_for / plan / alloc) is dtype-independent: a block
        #: holds block_size tokens either way, it just costs fewer
        #: bytes quantized.
        self.kv_dtype = str(kv_dtype)
        if self.kv_dtype not in _KV_ITEMSIZE:
            raise ValueError(
                "kv_dtype must be one of {}, got {!r}".format(
                    sorted(_KV_ITEMSIZE), kv_dtype))
        self._lock = threading.Lock()
        # LIFO free list: recently freed blocks are re-handed first
        self._free = list(range(self.num_blocks, 0, -1))
        self._ref = {}                # id -> refcount (> 0: live)
        self._by_key = {}             # token-chain key -> block id
        self._key_of = {}             # block id -> its registered key
        self._origin = {}             # block id -> "prompt"/"generated"
        # refcount-0 blocks still registered in the prefix cache, in
        # least-recently-released-first order (the eviction order)
        self._lru = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # generated-prefix accounting: registrations of
        # decode-filled blocks, and the subset of hits that landed on
        # one — the multi-turn reuse signal load_stats surfaces
        self.generated_registered = 0
        self.generated_hits = 0
        # per-block hit tally: how often each REGISTERED block
        # was found resident by a chain walk — the heat signal
        # :meth:`prefix_digest` ranks its top-K hottest chains by.
        # Dropped with the registration (eviction / drop_cache), so a
        # recycled block id never inherits a prior chain's heat.
        self._chain_hits = {}
        # mutation epoch: bumped by every state change that could alter
        # an admission verdict (alloc/release/acquire/register/
        # drop_cache). The engine's blocked-head memo keys on it — a
        # raw allocatable() reading can return to a memoized value
        # while a registration changed the head's need underneath it.
        self._epoch = 0

    # -- sizing ----------------------------------------------------------

    def blocks_for(self, n_tokens):
        """Blocks a sequence of ``n_tokens`` occupies (ceil)."""
        if n_tokens <= 0:
            return 0
        return (int(n_tokens) + self.block_size - 1) // self.block_size

    def block_bytes(self, num_heads, head_dim, layers=1):
        """Resident device bytes ONE block costs across ``layers``
        attention layers: K + V codes at :attr:`kv_dtype`, plus the
        per-head float32 scales int8 blocks carry alongside. The
        number ``estimate_admission``'s byte pricing and the
        fixed-byte-budget pool sizing
        read — int8 at head_dim 16 costs 40 bytes/token/layer/KV-pair
        vs float32's 128, so the same budget buys ~3.2x the blocks."""
        per_token = 2 * num_heads * head_dim * _KV_ITEMSIZE[self.kv_dtype]
        if self.kv_dtype == "int8":
            per_token += 2 * num_heads * 4  # the float32 scales
        return self.block_size * per_token * int(layers)

    @staticmethod
    def quantize(x):
        """Numpy mirror of ``ops.paged_attention.quantize_kv`` — the
        host reference the device write path is pinned against:
        ``[..., D]`` float -> (int8 codes, float32 per-head scales),
        symmetric absmax over the last axis, zero vectors to zero
        codes under scale 1.0. Same exact-round-trip fixed point:
        requantizing the dequantized grid reproduces codes and scales
        bitwise (tests/test_torch_paged_attention.py pins it against
        the port's torch op)."""
        x = np.asarray(x)
        # cast BEFORE dividing, exactly like the device op: dividing
        # in a wider input dtype (float64 numpy default) then casting
        # double-rounds the scale, shifting codes by ±1 vs the device
        s = np.max(np.abs(x), axis=-1).astype(np.float32) / 127.0
        s = np.where(s > 0, s, np.float32(1.0))
        q = np.clip(np.round(x.astype(np.float32) / s[..., None]),
                    -127, 127).astype(np.int8)
        return q, s

    @staticmethod
    def dequantize(q, s):
        """Inverse of :meth:`quantize`: codes x scales, float32."""
        return np.asarray(q, np.float32) \
            * np.asarray(s, np.float32)[..., None]

    def allocatable(self):
        """Blocks an ``alloc`` could supply right now: the free list
        plus every evictable (refcount-0) cached block."""
        with self._lock:
            return len(self._free) + len(self._lru)

    def stats(self):
        """{'total', 'free', 'cached', 'live', 'hits', 'misses',
        'evictions', 'hit_rate'} — the numbers ``load_stats`` /
        ``/healthz`` / the BEAT payload surface. ``free`` is
        ALLOCATABLE (free list + evictable cache); ``cached`` the
        evictable subset; ``live`` blocks referenced by in-flight
        sequences."""
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "total": self.num_blocks,
                "kv_dtype": self.kv_dtype,
                "free": len(self._free) + len(self._lru),
                "cached": len(self._lru),
                "live": len(self._ref),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "generated_registered": self.generated_registered,
                "generated_hits": self.generated_hits,
            }

    def prefix_digest(self, top_k=PREFIX_DIGEST_TOP_K):
        """Compact, bounded digest of the RESIDENT prefix-chain
        registry — the per-replica warmth signal the serving beat
        carries and the fleet router's prefix-aware dispatch matches
        prompts against.

        ``{'block_size', 'top': [[hash, depth], ...], 'truncated'}``:
        each entry is one registered chain as its truncated
        :func:`chain_digest` plus its depth in FULL blocks, hottest
        first (per-block hit tally desc, then depth desc — a deep
        resident conversation outranks a shallow one at equal heat —
        then the chain key itself, so the ordering is deterministic
        for a given registry state). Generated-origin chains are
        included exactly like prompt-origin ones: a turn-2 prompt
        matches the chain decode just extended. At most ``top_k``
        entries are published no matter how many chains are resident;
        ``truncated`` says whether anything was cut — the honesty flag
        that lets a router distinguish "cold" from "warm beyond what
        the digest shows"."""
        top_k = max(1, int(top_k))
        with self._lock:
            chains = [(self._chain_hits.get(bid, 0),
                       len(key) // self.block_size, key)
                      for bid, key in self._key_of.items()]
        chains.sort(key=lambda c: (-c[0], -c[1], c[2]))
        top = [[chain_digest(key, len(key)), depth]
               for _, depth, key in chains[:top_k]]
        return {"block_size": self.block_size, "top": top,
                "truncated": len(chains) > top_k}

    def epoch(self):
        """Mutation counter: changes whenever alloc / release /
        acquire / register / drop_cache changed pool state. Equal
        epochs guarantee an admission plan's verdict is unchanged."""
        with self._lock:
            return self._epoch

    def ref_count(self, block_id):
        """Live refcount of ``block_id`` (0 when unreferenced)."""
        with self._lock:
            return self._ref.get(int(block_id), 0)

    def live_refs(self):
        """{block_id: refcount} for every referenced block — the
        leak-audit view the churn test asserts empties."""
        with self._lock:
            return dict(self._ref)

    # -- prefix cache ----------------------------------------------------

    @staticmethod
    def _chain_key(tokens, n):
        return tuple(tokens[:n])

    def _walk_locked(self, tokens):
        """Longest resident chain of FULL blocks for ``tokens`` (caller
        holds ``_lock``), capped so at least one token is always left
        for the tail prefill (a fully-cached prompt still needs a
        forward pass to produce the logits its first generated token
        samples from). Returns ``(ids, shareable)`` — the ONE chain
        walk behind :meth:`match_prefix` and :meth:`plan`, so the
        admission gate's dry run can never disagree with what admission
        actually acquires."""
        shareable = max(0, (len(tokens) - 1) // self.block_size)
        ids = []
        for j in range(shareable):
            key = self._chain_key(tokens, (j + 1) * self.block_size)
            bid = self._by_key.get(key)
            if bid is None:
                break
            ids.append(bid)
        return ids, shareable

    def match_prefix(self, tokens, count_generated=True):
        """Resident shared-prefix block ids for ``tokens``, in chain
        order. Does NOT take references — call :meth:`acquire` before
        using them. Tallies hits/misses; generated-origin hits tally
        separately unless ``count_generated=False`` — the engine
        passes False for a preemption continuation's re-admission,
        whose walk lands back on the blocks the SAME request
        registered before being preempted (counting those would read
        as multi-turn reuse during a pure pool-pressure storm)."""
        tokens = list(tokens)
        with self._lock:
            ids, shareable = self._walk_locked(tokens)
            self.hits += len(ids)
            self.misses += shareable - len(ids)
            for bid in ids:
                self._chain_hits[bid] = self._chain_hits.get(bid, 0) + 1
            if count_generated:
                self.generated_hits += sum(
                    1 for bid in ids
                    if self._origin.get(bid) == "generated")
        return ids

    def resident_chain(self, tokens, acquire=False):
        """Longest resident chain of FULL blocks for ``tokens``,
        UNCAPPED — the KV-export walk (prefill/decode disaggregation). Where
        :meth:`_walk_locked` stops at ``(len - 1) // block_size`` so
        admission always leaves a tail token to prefill, a prefill
        worker exporting a finished prompt wants every block admission
        registered — ``len(tokens) // block_size`` of them — because
        the DEEPEST block is exactly the one a decode-tier adopter
        saves the most prefill on. Tallies no hits (an export probe is
        not a cache lookup). With ``acquire`` the walk takes one
        reference per returned block UNDER THE SAME LOCK — the export
        path needs walk-then-pin to be atomic, or a concurrent
        ``drop_cache`` / eviction could free a block between the two
        (callers :meth:`release` when done). Read-only otherwise.
        Returns ``[(block_id, origin), ...]`` in chain order."""
        tokens = list(tokens)
        out = []
        with self._lock:
            for j in range(len(tokens) // self.block_size):
                key = self._chain_key(tokens, (j + 1) * self.block_size)
                bid = self._by_key.get(key)
                if bid is None:
                    break
                out.append((bid, self._origin.get(bid, "prompt")))
            if acquire and out:
                self._epoch += 1
                for bid, _ in out:
                    self._ref[bid] = self._ref.get(bid, 0) + 1
                    self._lru.pop(bid, None)
        return out

    def plan(self, tokens):
        """(shared_ids, new_blocks_needed, lru_resident) for admitting
        ``tokens`` — the admission gate's dry run (no refs taken, no
        tallies). ``lru_resident`` counts the shared blocks currently
        parked in the LRU: acquiring THOSE removes capacity from
        :meth:`allocatable`, while sharing a LIVE block (another
        in-flight sequence holds a reference) costs nothing — the
        distinction that lets concurrent same-prefix requests admit
        together instead of serializing on a pool-sized prefix.

        NOTE: pricing a plan against capacity needs
        :meth:`plan_admission` — a separate ``allocatable()`` call is
        a SECOND lock acquisition, and the pool can mutate between the
        two (a torn read: an admission
        estimate on an HTTP handler thread straddling the scheduler's
        ``acquire`` double-counted the deficit and shed feasible
        deadlines)."""
        ids, need, lru_resident, _, _ = self.plan_admission(tokens)
        return ids, need, lru_resident

    def plan_admission(self, tokens):
        """(shared_ids, new_blocks_needed, lru_resident, allocatable,
        epoch) — :meth:`plan` plus the pool's current capacity and
        mutation epoch, all read under ONE lock hold, so the deficit
        ``new_needed + lru_resident - allocatable`` is priced against
        a single consistent snapshot and the epoch provably matches
        the verdict (the blocked-head memo's key). Invariant a torn
        read breaks and this cannot: ``lru_resident`` and
        ``allocatable`` move together when a chain is acquired, so
        ``lru_resident + (total - allocatable)`` never exceeds the
        chain's own length plus the truly-live block count (pinned by
        the concurrent churn test of the JAX package's
        tests/test_paged_kv.py)."""
        tokens = list(tokens)
        with self._lock:
            ids, _ = self._walk_locked(tokens)
            lru_resident = sum(1 for bid in ids if bid in self._lru)
            allocatable = len(self._free) + len(self._lru)
            epoch = self._epoch
        return (ids, self.blocks_for(len(tokens)) - len(ids),
                lru_resident, allocatable, epoch)

    def register(self, tokens, n_tokens, block_id, origin="prompt"):
        """Publish ``block_id`` as holding the K/V of the FULL block
        ending at ``n_tokens`` (``tokens[:n_tokens]`` is its chain
        key; ``n_tokens`` must be a block multiple). First writer
        wins: if the chain is already registered to another block the
        existing entry stands and this one stays private. ``origin``
        ("prompt" / "generated") tags where the block's content came
        from — the engine registers decode-filled blocks as
        "generated" so multi-turn reuse is separately countable."""
        if n_tokens % self.block_size:
            raise ValueError(
                "register at {} tokens: not a multiple of block_size {}"
                .format(n_tokens, self.block_size))
        key = self._chain_key(tokens, n_tokens)
        with self._lock:
            bid = int(block_id)
            if key in self._by_key or bid in self._key_of:
                return
            if self._ref.get(bid, 0) < 1:
                raise ValueError(
                    "register of unreferenced block {}".format(bid))
            self._by_key[key] = bid
            self._key_of[bid] = key
            self._origin[bid] = str(origin)
            if origin == "generated":
                self.generated_registered += 1
            self._epoch += 1

    def drop_cache(self):
        """Unregister every EVICTABLE cached block and return it to the
        free list (live shared blocks keep their registration). The
        operator's 'flush the prefix cache' hook, and how the leak test
        proves retention is cache, not leak. Returns the count."""
        with self._lock:
            dropped = list(self._lru)
            if dropped:
                self._epoch += 1
            for bid in dropped:
                self._lru.pop(bid)
                key = self._key_of.pop(bid)
                self._by_key.pop(key)
                self._origin.pop(bid, None)
                self._chain_hits.pop(bid, None)
                self._free.append(bid)
            return len(dropped)

    # -- allocation ------------------------------------------------------

    def acquire(self, block_ids):
        """Take one reference on each shared block in ``block_ids`` (a
        refcount-0 cached block leaves the LRU: it is live again)."""
        with self._lock:
            if block_ids:
                self._epoch += 1
            for bid in block_ids:
                bid = int(bid)
                self._ref[bid] = self._ref.get(bid, 0) + 1
                self._lru.pop(bid, None)

    def alloc(self, n):
        """``n`` fresh private blocks (refcount 1 each), from the free
        list first, then by evicting least-recently-released cached
        blocks. Raises :class:`PoolExhausted` (allocating NOTHING) if
        fewer than ``n`` are obtainable."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) + len(self._lru) < n:
                raise PoolExhausted(
                    "need {} block(s); {} free + {} cached evictable "
                    "of {} total".format(n, len(self._free),
                                         len(self._lru), self.num_blocks))
            self._epoch += 1
            ids = []
            while len(ids) < n:
                if self._free:
                    ids.append(self._free.pop())
                    continue
                bid, _ = self._lru.popitem(last=False)  # oldest first
                key = self._key_of.pop(bid)
                self._by_key.pop(key)
                self._origin.pop(bid, None)
                self._chain_hits.pop(bid, None)
                self.evictions += 1
                ids.append(bid)
            for bid in ids:
                self._ref[bid] = 1
            return ids

    def release(self, block_ids):
        """Drop one reference per block. A block reaching refcount 0
        returns to the free list — unless it is registered in the
        prefix cache, in which case it parks in the LRU (evictable,
        still hittable)."""
        with self._lock:
            if block_ids:
                self._epoch += 1
            for bid in block_ids:
                bid = int(bid)
                left = self._ref.get(bid, 0) - 1
                if left < 0:
                    raise ValueError(
                        "release of unreferenced block {}".format(bid))
                if left:
                    self._ref[bid] = left
                    continue
                del self._ref[bid]
                if bid in self._key_of:
                    self._lru[bid] = None
                    self._lru.move_to_end(bid)
                else:
                    self._free.append(bid)

"""Multi-tenant QoS plane: priority classes, weighted-fair admission,
per-tenant token quotas — the port's copy of
``tensorflowonspark_tpu/qos.py`` (stdlib only, the same classes, the
same tie-breaks).

The serving stack is production-shaped everywhere except admission:
one FIFO queue means a single aggressive client IS the fleet's p99.
This module is the pure core of the fix — no locks, no clocks of its
own, no engine imports — so every scheduling property is table-testable
without spinning a scheduler thread:

- :func:`validate_tenant` / :func:`validate_priority` — the identity
  gate. Tenant identity enters at ``DecodeEngine.submit(tenant=,
  priority=)`` and the ``:generate`` body; malformed values raise
  ``ValueError`` (HTTP 400), absent values fall back to
  ``DEFAULT_TENANT`` / ``DEFAULT_PRIORITY`` so every existing caller
  is unchanged.
- :class:`FairScheduler` — deficit-counter weighted-fair queuing with
  strict priority classes. Replaces the FIFO head scan inside the
  engine's race-free ``plan_admission`` snapshot; the engine charges
  it in SLOT units on contiguous engines and in KV-BLOCK units on
  paged ones, so fairness holds at both admission boundaries.
- :class:`TokenBucket` / :class:`QuotaTable` — per-tenant token-rate
  quotas, post-paid: the bucket is drained by the engine's own
  tokens-per-step delivery counts (exact usage, never an estimate —
  and a dedup-replayed retry delivers nothing new, so it can never
  double-charge), and admission refuses with
  :class:`QuotaExceeded` (HTTP 429 + honest Retry-After) while the
  bucket is in debt.

Everything here is deterministic given its inputs: ties break on the
tenant name, and time is an argument, not a syscall.
"""

import re
import threading
import time

#: priority classes, strongest first; admission is STRICTLY ordered by
#: class (a waiting ``high`` beats any ``normal``/``low`` regardless of
#: deficit) and weighted-fair WITHIN a class
PRIORITIES = ("high", "normal", "low")
PRIORITY_RANK = {name: rank for rank, name in enumerate(PRIORITIES)}

DEFAULT_TENANT = "default"
DEFAULT_PRIORITY = "normal"

#: reserved tenant for the SLO plane's synthetic canary probes: always
#: issued at ``low`` priority (the class that never preempts and never
#: displaces waiting real traffic), so a canary's presence is invisible
#: to every other tenant's latency. Real callers should not mint
#: traffic under this name — its tallies are interpreted as black-box
#: probe results, not customer load.
CANARY_TENANT = "slo-canary"

#: tenant identity grammar: it becomes a metric label value and a
#: ``X-TFOS-Tenant`` header, so it is deliberately narrow — no quotes,
#: no spaces, no control characters, bounded length
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def validate_tenant(tenant):
    """Normalized tenant id, or ``ValueError`` on a malformed one.
    ``None`` means the caller never opted in: :data:`DEFAULT_TENANT`
    (the existing single-tenant behavior, unchanged)."""
    if tenant is None:
        return DEFAULT_TENANT
    if not isinstance(tenant, str) or not _TENANT_RE.match(tenant):
        raise ValueError(
            "malformed tenant {!r}: want 1-64 chars of "
            "[A-Za-z0-9._-], starting alphanumeric".format(tenant))
    return tenant


def validate_priority(priority):
    """Normalized priority class name, or ``ValueError``. ``None``
    means :data:`DEFAULT_PRIORITY`."""
    if priority is None:
        return DEFAULT_PRIORITY
    if isinstance(priority, str) and priority.lower() in PRIORITY_RANK:
        return priority.lower()
    raise ValueError(
        "malformed priority {!r}: want one of {}".format(
            priority, "/".join(PRIORITIES)))


def priority_rank(priority):
    """Class rank (0 strongest); unknown/None ranks as ``normal`` —
    rank is a sort key, never a validation gate."""
    return PRIORITY_RANK.get(priority, PRIORITY_RANK[DEFAULT_PRIORITY])


class QuotaExceeded(RuntimeError):
    """A tenant's token bucket is in debt: refused at admission with
    an honest ``retry_after`` (seconds until the bucket refills past
    zero at the tenant's configured rate). Maps to HTTP 429 +
    ``Retry-After`` with ``kind: QuotaExceeded`` — distinct from
    ``QueueFull``'s 429, which is load, failover-able; a quota 429 is
    POLICY and follows the tenant to every replica."""

    def __init__(self, msg, tenant=DEFAULT_TENANT, retry_after=1.0):
        super(QuotaExceeded, self).__init__(msg)
        self.tenant = tenant
        self.retry_after = max(1.0, float(retry_after))


class QosPolicy(object):
    """The operator-facing QoS configuration: per-tenant weights (the
    fair-share ratios) and per-tenant token-rate quotas.

    - ``weights``: {tenant: share weight > 0}; unlisted tenants get
      ``default_weight``. Weights are RATIOS — {a: 3, b: 1} admits a
      3 tokens of service for every 1 of b while both are backlogged.
    - ``quotas``: {tenant: generated tokens/second > 0}; unlisted
      tenants get ``default_quota``; ``None`` anywhere = unlimited.
    - ``burst_s``: bucket capacity in seconds of rate — how far a
      tenant may burst above its sustained rate from a full bucket.

    Plain attributes, no locks: picklable verbatim (it rides the
    ``serve_replica`` executor spec and ``DecodeEngine._spawn_args``).
    """

    def __init__(self, weights=None, default_weight=1.0, quotas=None,
                 default_quota=None, burst_s=2.0):
        self.weights = {}
        for tenant, weight in (weights or {}).items():
            if not float(weight) > 0:
                raise ValueError(
                    "tenant {!r} weight must be > 0, got {!r}".format(
                        tenant, weight))
            self.weights[validate_tenant(tenant)] = float(weight)
        if not float(default_weight) > 0:
            raise ValueError("default_weight must be > 0")
        self.default_weight = float(default_weight)
        self.quotas = {}
        for tenant, rate in (quotas or {}).items():
            if rate is not None and not float(rate) > 0:
                raise ValueError(
                    "tenant {!r} quota must be > 0 tokens/s or None, "
                    "got {!r}".format(tenant, rate))
            self.quotas[validate_tenant(tenant)] = \
                None if rate is None else float(rate)
        self.default_quota = None if default_quota is None \
            else float(default_quota)
        if self.default_quota is not None and not self.default_quota > 0:
            raise ValueError("default_quota must be > 0 or None")
        self.burst_s = max(0.0, float(burst_s))

    def weight(self, tenant):
        return self.weights.get(tenant, self.default_weight)

    def quota(self, tenant):
        """tokens/second for ``tenant``, or None (unlimited)."""
        return self.quotas.get(tenant, self.default_quota)

    @classmethod
    def from_spec(cls, spec):
        """Coerce an engine/router ``qos=`` argument: None (all
        defaults), an existing policy (verbatim), or a kwargs dict."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(
            "qos spec must be None, QosPolicy, or a kwargs dict, "
            "got {!r}".format(type(spec).__name__))


class FairScheduler(object):
    """Deficit-counter weighted-fair admission across tenants, with
    strict priority classes on top.

    The accounting is exact fair-share bookkeeping: each admission of
    ``cost`` service units by tenant *t* charges *t* the full cost and
    credits EVERY backlogged tenant (including *t*) its weighted share
    ``cost * w_i / W`` of that service. A tenant's deficit counter is
    therefore (entitled service − received service): zero-sum across
    backlogged tenants, growing for anyone waiting, shrinking for
    anyone over-served — so a starved tenant's deficit rises until it
    wins, and PROVABLY catches up (the deficit only drains by being
    served). Idle tenants earn nothing: no credit hoarding across
    idle gaps.

    :meth:`select` is a pure read; :meth:`charge` is the only
    mutation. Single-threaded by design — the engine calls both from
    its scheduler thread inside the ``plan_admission`` snapshot.
    """

    def __init__(self, policy=None, credit_bound=None):
        self.policy = policy if policy is not None else QosPolicy()
        #: tenant -> deficit counter, in the engine's admission cost
        #: units (slots on contiguous engines, KV blocks on paged)
        self._deficit = {}
        #: optional clamp on |deficit|: bounds how long a once-starved
        #: tenant may dominate after the backlog clears (None = exact
        #: accounting, unbounded memory of starvation)
        self.credit_bound = None if credit_bound is None \
            else abs(float(credit_bound))

    def deficit(self, tenant):
        return self._deficit.get(tenant, 0.0)

    def select(self, candidates):
        """Index of the candidate to admit next, or None when empty.

        ``candidates``: sequence of ``(tenant, priority)`` pairs, one
        per runnable queue head. Strict class order first; within the
        strongest present class the largest deficit wins; ties break
        on the tenant name (then input order) for determinism. Pure —
        no state changes."""
        best = None
        best_key = None
        for i, (tenant, priority) in enumerate(candidates):
            key = (priority_rank(priority),
                   -self._deficit.get(tenant, 0.0), str(tenant), i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def charge(self, tenant, cost, backlogged=None):
        """Account one admission: ``tenant`` received ``cost`` service
        units while ``backlogged`` tenants (unique names, winner
        included; defaults to just the winner) had work waiting."""
        cost = max(0.0, float(cost))
        if not cost:
            return
        tenants = set(backlogged) if backlogged else {tenant}
        tenants.add(tenant)
        total_w = sum(self.policy.weight(t) for t in tenants)
        for t in tenants:
            share = cost * self.policy.weight(t) / total_w
            self._deficit[t] = self._deficit.get(t, 0.0) + share
        self._deficit[tenant] = self._deficit.get(tenant, 0.0) - cost
        if self.credit_bound is not None:
            for t in tenants:
                self._deficit[t] = max(
                    -self.credit_bound,
                    min(self.credit_bound, self._deficit[t]))

    def forget(self, tenant):
        """Drop a tenant's counter (it went fully idle — completed and
        queued-nothing); keeps the table bounded by LIVE tenants."""
        self._deficit.pop(tenant, None)

    def snapshot(self):
        return dict(self._deficit)


class TokenBucket(object):
    """One tenant's token-rate bucket, post-paid: :meth:`charge` is
    driven by the engine's ACTUAL per-step token deliveries (so usage
    accounting is exact and a dedup-replayed retry — which delivers
    nothing new — can never double-charge), and may push the level
    into debt; :meth:`admissible` refuses new admissions while in
    debt. Capacity ``burst_s * rate`` bounds how far a full bucket can
    burst above the sustained rate. Time is an argument — the table
    tests drive it by hand."""

    def __init__(self, rate, burst_s=2.0, now=0.0):
        self.rate = float(rate)
        if not self.rate > 0:
            raise ValueError("rate must be > 0 tokens/s")
        self.capacity = max(self.rate * float(burst_s), 1.0)
        self.level = self.capacity
        self._t = float(now)

    def refill(self, now):
        dt = max(0.0, float(now) - self._t)
        self.level = min(self.capacity, self.level + dt * self.rate)
        self._t = float(now)

    def admissible(self, now):
        self.refill(now)
        return self.level > 0.0

    def charge(self, tokens, now):
        self.refill(now)
        self.level -= max(0.0, float(tokens))

    def retry_after(self, now):
        """Seconds until the level refills past zero (0.0 when already
        admissible) — the honest Retry-After a quota 429 carries."""
        self.refill(now)
        if self.level > 0.0:
            return 0.0
        return -self.level / self.rate


class QuotaTable(object):
    """Thread-safe per-tenant bucket table over a :class:`QosPolicy`.

    Two writer populations touch it: HTTP handler threads (admission
    checks in ``submit``) and the engine's scheduler thread (usage
    charges at token delivery) — hence its own lock, unlike the pure
    single-threaded :class:`FairScheduler`. Tenants without a
    configured quota cost one dict probe and no bucket."""

    def __init__(self, policy=None, clock=time.monotonic):
        self.policy = policy if policy is not None else QosPolicy()
        self._clock = clock
        self._buckets = {}
        self._lock = threading.Lock()

    def _bucket_locked(self, tenant, now):
        bucket = self._buckets.get(tenant)
        if bucket is None:
            rate = self.policy.quota(tenant)
            if rate is None:
                return None
            bucket = TokenBucket(rate, burst_s=self.policy.burst_s,
                                 now=now)
            self._buckets[tenant] = bucket
        return bucket

    def admit(self, tenant, now=None):
        """Raise :class:`QuotaExceeded` when ``tenant``'s bucket is in
        debt; no-op for unlimited tenants. Never charges — admission
        checks are free, usage pays."""
        now = self._clock() if now is None else now
        with self._lock:
            bucket = self._bucket_locked(tenant, now)
            if bucket is None or bucket.admissible(now):
                return
            retry_after = bucket.retry_after(now)
        raise QuotaExceeded(
            "tenant {!r} over token quota ({} tokens/s): retry in "
            "{:.1f}s".format(tenant, bucket.rate, retry_after),
            tenant=tenant, retry_after=retry_after)

    def charge(self, tenant, tokens, now=None):
        """Drain ``tokens`` of actual usage from ``tenant``'s bucket
        (may go into debt — that is the backpressure signal admission
        reads). No-op for unlimited tenants."""
        if not tokens:
            return
        now = self._clock() if now is None else now
        with self._lock:
            bucket = self._bucket_locked(tenant, now)
            if bucket is not None:
                bucket.charge(tokens, now)

    def snapshot(self):
        """{tenant: bucket level} for the tenants with live buckets."""
        with self._lock:
            return {t: b.level for t, b in self._buckets.items()}

    def restore(self, levels, now=None):
        """Seed bucket levels from another table's :meth:`snapshot` —
        the warm-standby takeover path: a standby router that
        followed the leader's quota state restores it here so a tenant
        in debt cannot launder its backlog through the failover.
        Tenants without a configured quota are skipped; levels clamp
        to each bucket's capacity (a stale over-full snapshot must not
        mint burst credit). Restoring into a bucket that already has
        live charges keeps the LOWER level — never forgives debt."""
        now = self._clock() if now is None else now
        with self._lock:
            for tenant, level in (levels or {}).items():
                bucket = self._bucket_locked(tenant, now)
                if bucket is None:
                    continue
                bucket.refill(now)
                bucket.level = min(bucket.level,
                                   min(bucket.capacity, float(level)))

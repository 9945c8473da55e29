"""The port's QoS plane against the JAX reference.

- PURE: ``tensorflowonspark_tpu_torch/qos.py`` is a copy of the
  reference's ``qos.py``. The reference's own unit cases
  (``tests/test_qos.py``: identity validation, ``FairScheduler`` table
  tests, ``TokenBucket`` / ``QuotaTable`` under injected clocks) run
  against BOTH modules, and seeded random call sequences drive both side
  by side, step for step, with equal picks, deficits and bucket levels.
- ENGINE: the same queued two-tenant mix — with a ``high`` arrival that
  preempts a ``low`` slot — goes through the JAX ``DecodeEngine`` and
  the port's (weights converted by ``convert.from_flax``) and gives the
  same admission order and the same tokens at temperature 0; one tenant
  at one class is the plain FIFO; a malformed ``tenant`` / ``priority``
  is a 400 on both servers (the port used to accept and ignore them).
"""

import http.client
import importlib.util
import json
import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorflowonspark_tpu import chaos as jchaos
from tensorflowonspark_tpu import qos as jqos
from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import chaos, convert, qos, serving
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

HERE = os.path.dirname(os.path.abspath(__file__))
V, H, NH, L, MAXLEN = 17, 32, 4, 2, 64


def _port_name(name):
    """``tensorflowonspark_tpu[.x]`` -> ``tensorflowonspark_tpu_torch[.x]``."""
    base = "tensorflowonspark_tpu"
    if name == base or name.startswith(base + "."):
        return base + "_torch" + name[len(base):]
    return name


def port_code(code):
    """``code`` with every import of the JAX package inside it (its own
    body and the functions nested in it) pointed at the port's module of
    the same name: ``from tensorflowonspark_tpu import chaos`` imports
    the port's ``chaos``. The reference's map_funs import what they use
    inside their bodies, since they run in trainer processes."""
    consts = tuple(port_code(c) if isinstance(c, types.CodeType) else c
                   for c in code.co_consts)
    return code.replace(co_names=tuple(_port_name(n)
                                       for n in code.co_names),
                        co_consts=consts)


def reference_cases(filename, port_imports=False, **port_modules):
    """``(reference test module, port namespace)``: the reference test
    file loaded under a private name, and a copy of its globals in which
    ``port_modules`` replace the reference's modules of those names, with
    every function and plain helper class of the file rebound to it — so
    ``ns[case]()`` runs the reference's own case against the port.
    ``port_imports`` also points the imports inside the rebound
    functions' bodies at the port (:func:`port_code`): what a rebound
    map_fun ships to a trainer imports the port there."""
    name = "_reference_" + filename[:-3]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, filename))
    ref = importlib.util.module_from_spec(spec)
    # a reference file may look itself up while it loads (the files
    # whose map_funs ship by value register their own module)
    sys.modules.setdefault(name, ref)
    spec.loader.exec_module(ref)
    ns = dict(ref.__dict__)
    ns.update(port_modules)

    def rebind(fn):
        code = port_code(fn.__code__) if port_imports else fn.__code__
        return types.FunctionType(code, ns, fn.__name__,
                                  fn.__defaults__, fn.__closure__)

    for key, obj in ref.__dict__.items():
        if isinstance(obj, types.FunctionType) and obj.__module__ == name:
            ns[key] = rebind(obj)
        elif isinstance(obj, type) and obj.__module__ == name \
                and obj.__bases__ == (object,):
            ns[key] = type(key, (object,), {
                k: rebind(v) if isinstance(v, types.FunctionType) else v
                for k, v in obj.__dict__.items()
                if k not in ("__dict__", "__weakref__")})
    return ref, ns


REF, PORT = reference_cases("test_qos.py", qos=qos)

PURE_CASES = (
    "test_validate_tenant_grammar_and_default",
    "test_validate_priority_and_rank",
    "test_policy_from_spec_coercion_and_validation",
    "test_select_empty_and_one_tenant_degeneracy",
    "test_priority_strictly_outranks_deficit",
    "test_deficit_starved_tenant_provably_catches_up",
    "test_weighted_shares_within_10pct_over_1k_rounds",
    "test_charge_zero_sum_forget_and_credit_bound",
    "test_idle_tenants_earn_no_credit",
    "test_token_bucket_burst_debt_and_honest_retry_after",
    "test_quota_table_admit_never_charges_post_paid_exact",
    "test_quota_table_unlimited_tenant_has_no_bucket",
    "test_quota_table_restore_never_forgives_debt",
)


@pytest.mark.parametrize("case", PURE_CASES)
def test_reference_unit_case_on_both_modules(case):
    getattr(REF, case)()
    PORT[case]()


def _same_calls(mod, seed):
    """One seeded call sequence against ``mod``'s FairScheduler,
    TokenBucket and QuotaTable; returns every observable."""
    rng = np.random.RandomState(seed)
    tenants = ["t%d" % i for i in range(4)]
    policy = mod.QosPolicy(weights={"t0": 3.0, "t2": 0.5},
                           quotas={"t1": 5.0, "t3": 2.0}, burst_s=1.5)
    sched = mod.FairScheduler(policy, credit_bound=None if seed % 2
                              else 25.0)
    clock = [0.0]
    table = mod.QuotaTable(policy, clock=lambda: clock[0])
    bucket = mod.TokenBucket(4.0, burst_s=2.0, now=0.0)
    out = []
    for _ in range(300):
        cands = [(t, mod.PRIORITIES[rng.randint(3)])
                 for t in tenants if rng.rand() < 0.7]
        pick = sched.select(cands)
        if pick is not None:
            sched.charge(cands[pick][0], float(rng.randint(1, 6)),
                         backlogged={t for t, _ in cands})
        if rng.rand() < 0.05 and cands:
            sched.forget(cands[0][0])
        clock[0] += float(rng.rand())
        tenant = tenants[rng.randint(4)]
        try:
            table.admit(tenant)
            admitted = None
        except mod.QuotaExceeded as e:
            admitted = (e.tenant, round(e.retry_after, 12))
        table.charge(tenant, int(rng.randint(0, 8)))
        bucket.charge(float(rng.randint(0, 5)), clock[0])
        out.append((pick, sorted(sched.snapshot().items()), admitted,
                    sorted(table.snapshot().items()),
                    bucket.admissible(clock[0]), bucket.retry_after(
                        clock[0])))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_identical_call_sequences_give_identical_state(seed):
    assert _same_calls(qos, seed) == _same_calls(jqos, seed)


@pytest.mark.parametrize("kind,value", [
    ("tenant", ""), ("tenant", "-x"), ("tenant", "a b"), ("tenant", 5),
    ("tenant", "x" * 65), ("tenant", ["a"]), ("priority", "urgent"),
    ("priority", 1), ("priority", ""), ("tenant", None),
    ("priority", None), ("priority", "HIGH"), ("tenant", "team-a.prod_1")])
def test_validation_errors_match(kind, value):
    fn = "validate_" + kind

    def verdict(mod):
        try:
            return "ok", getattr(mod, fn)(value)
        except (TypeError, ValueError) as e:
            return type(e).__name__, str(e)

    assert verdict(qos) == verdict(jqos)


# -- engine level -----------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    train = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L,
                  max_len=MAXLEN)
    params = train.init(jax.random.PRNGKey(7),
                        jnp.zeros((2, MAXLEN), jnp.int32))["params"]
    dec = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L,
                max_len=MAXLEN, decode=True)
    return dec, params


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.disarm()
    jchaos.disarm()


def _port(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=MAXLEN)
    m.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return m


def _engines(lm, **kw):
    dec, params = lm
    return ((jserving.DecodeEngine(dec, params, **kw), jchaos),
            (serving.DecodeEngine(_port(params), device="cpu", **kw),
             chaos))


def _admission_order(handles):
    """Request indices in the order their prefills ran (a preempted
    request appears again at its continuation)."""
    events = sorted((t0, i) for i, h in enumerate(handles)
                    for name, t0, _ in h._attr_spans if name == "prefill")
    return [i for _, i in events]


def _wait_admitted(handles, timeout=120):
    deadline = time.monotonic() + timeout
    while any(h._decode_t0 is None for h in handles):
        assert time.monotonic() < deadline, "not admitted in time"
        time.sleep(0.002)


def _run_mix(eng, ch):
    """Two ``low`` requests fill both slots; during a held step boundary
    the mix arrives at once (``_cv`` held, so no scan sees half of it):
    tenant ``a`` x3 and ``b`` x1 at ``normal``, and one ``vip`` at
    ``high``, which preempts the younger ``low`` slot."""
    with eng:
        ch.arm("stall_decode_for=1.5")
        with eng._cv:
            lows = [eng.submit([1 + i, 2, 3], 24, tenant="bg",
                               priority="low") for i in range(2)]
        _wait_admitted(lows)
        with eng._cv:
            mix = [eng.submit([4 + i, 5, 6, 7], 6, tenant="a")
                   for i in range(3)]
            mix.append(eng.submit([9, 9, 1], 6, tenant="b"))
            mix.append(eng.submit([8, 7, 6], 5, tenant="vip",
                                  priority="high"))
        handles = lows + mix
        tokens = [h.result(120) for h in handles]
        return (tokens, _admission_order(handles), eng.qos_tallies())


def test_two_tenant_mix_with_high_arrival_same_order_and_tokens(lm):
    (jeng, jch), (teng, tch) = _engines(
        lm, slots=2, kv_block_size=8, kv_blocks=16, prefix_cache=False)
    want = _run_mix(jeng, jch)
    got = _run_mix(teng, tch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    # the high request preempted a low slot and went next; b's single
    # request was not starved behind all of a's
    order = got[1]
    assert order[:2] in ([0, 1], [1, 0]) and order[2] == 6
    assert ("bg", "low") in got[2]["preemptions"]
    assert order.index(5) < max(order.index(i) for i in (2, 3, 4))


def _run_fifo(eng):
    with eng:
        with eng._cv:
            handles = [eng.submit([1 + i, 2, 3], 3) for i in range(5)]
        tokens = [h.result(120) for h in handles]
        return tokens, _admission_order(handles), eng.qos_tallies()


def test_single_tenant_degenerates_to_fifo(lm):
    (jeng, _), (teng, _) = _engines(lm, slots=1)
    want = _run_fifo(jeng)
    got = _run_fifo(teng)
    assert got == want
    assert got[1] == [0, 1, 2, 3, 4]
    assert got[2]["admitted"] == {("default", "normal"): 5}


def _run_antagonist(eng):
    with eng:
        with eng._cv:
            handles = [eng.submit([1 + i % 7, 2, 3], 3, tenant="antagonist")
                       for i in range(8)]
            handles += [eng.submit([5, 4 + i, 3], 3, tenant="quiet")
                        for i in range(2)]
        tokens = [h.result(120) for h in handles]
        return tokens, _admission_order(handles)


def test_antagonist_cannot_starve_quiet_tenant_same_on_both(lm):
    (jeng, _), (teng, _) = _engines(
        lm, slots=1, qos_policy={"weights": {"antagonist": 1.0,
                                             "quiet": 1.0}})
    want = _run_antagonist(jeng)
    got = _run_antagonist(teng)
    assert got == want
    order = got[1]
    last_antagonist = max(order.index(i) for i in range(8))
    assert all(order.index(q) < last_antagonist for q in (8, 9))


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/models/lm:generate",
                 body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("field,value", [
    ("tenant", 5), ("tenant", "a b"), ("priority", "urgent"),
    ("priority", 3), ("session", 7)])
def test_malformed_identity_is_400_on_both_servers(lm, field, value):
    dec, params = lm
    payload = {"prompt": [1, 2, 3], "max_new_tokens": 2, field: value}
    jeng = jserving.DecodeEngine(dec, params, slots=1)
    with pytest.raises(jserving._BadRequest):
        jserving.ModelServer(None, engine=jeng).generate(payload)
    jeng.stop()
    eng = serving.DecodeEngine(_port(params), slots=1, device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0,
                                  engine=eng) as srv:
        with pytest.raises(serving._BadRequest):
            srv.generate(payload)
        status, body = _post(srv.address[1], payload)
        assert status == 400, body
        # nothing was queued or served for the refused body
        assert eng.counters.get("prefills") == 0
        ok = dict(payload, **{field: {"tenant": "alpha",
                                      "priority": "high",
                                      "session": "s-1"}[field]})
        assert _post(srv.address[1], ok)[0] == 200


def test_quota_429_with_retry_after_nothing_queued(lm):
    _, params = lm
    policy = {"quotas": {"capped": 2.0}, "burst_s": 1.0}
    eng = serving.DecodeEngine(_port(params), slots=2, qos_policy=policy,
                               device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0,
                                  engine=eng) as srv:
        port = srv.address[1]
        # post-paid: the first request runs and leaves decisive debt
        assert _post(port, {"prompt": [1, 2], "max_new_tokens": 10,
                            "tenant": "capped"})[0] == 200
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/models/lm:generate",
                     body=json.dumps({"prompt": [3, 4], "max_new_tokens": 2,
                                      "tenant": "capped"}).encode())
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 429 and body["kind"] == "QuotaExceeded"
        assert int(resp.getheader("Retry-After")) >= 1
        assert eng.counters.get("prefills") == 1
        assert eng.qos_tallies()["quota_rejections"] == {"capped": 1}
        # another tenant is untouched by one tenant's debt
        assert _post(port, {"prompt": [5, 6], "max_new_tokens": 3})[0] \
            == 200

"""The port's decode engine held against the reference's engine files.

The cases of ``tests/test_paged_kv.py``, ``test_decode_engine.py`` and
``test_serving_lifecycle.py`` (every case but the slow ones and the six
named in ``LEFT_OUT``) run against the port through
``test_torch_fleet.port_namespace``: ``DecodeEngine(model, params,
...)`` keeps the reference's call shape with the port's engine on the
CPU, the model is the port's ``DecoderLM`` at each file's widths on the
JAX params (``convert.from_flax``), and ``_solo`` is the JAX package's
``generate_jit`` at those widths, so every served token is held against
the reference's generate. The cases themselves are not copied.

One direct case follows: a paged engine's prefix-digest gauges exist
from construction on and ``load_stats()`` sets them, with no scrape in
between.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_fleet
from tensorflowonspark_tpu import generation as jgen
from tensorflowonspark_tpu.models.decoder import DecoderLM as JDecoderLM
from tensorflowonspark_tpu_torch import chaos, convert, supervisor
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

FILES = ("test_paged_kv.py", "test_decode_engine.py",
         "test_serving_lifecycle.py")

#: cases that cannot run on the port, each with its reason
LEFT_OUT = {
    ("test_paged_kv.py", "test_solo_generate_rejects_paged_model"):
        "calls flax's Module.clone on the model",
    ("test_decode_engine.py", "test_compile_count_bounded_by_buckets"):
        "builds and initialises a flax DecoderLM inline",
    ("test_decode_engine.py", "test_engine_failure_fails_clients_not_hangs"):
        "poisons eng.params with a jax array",
    ("test_serving_lifecycle.py",
     "test_supervisor_restarts_dead_engine_and_rearms_server"):
        "poisons eng.params with a jax array",
    ("test_serving_lifecycle.py",
     "test_restart_exhaustion_marks_server_unhealthy"):
        "poisons eng.params with a jax array",
    ("test_decode_engine.py", "test_engine_rejects_bad_sampling_config"):
        "the port's sampling refusal asks for a torch.Generator where the "
        "reference's names a PRNG key (a wording, not a fault)",
}


def _widths(ref):
    return ref.V, ref.H, ref.NH, ref.L, ref.MAXLEN


def _namespace(filename):
    ref, ns = test_torch_fleet.port_namespace(filename,
                                              supervisor=supervisor)
    V, H, NH, L, MAXLEN = _widths(ref)
    jdec = JDecoderLM(vocab=V, hidden=H, num_heads=NH, num_layers=L,
                      max_len=MAXLEN, decode=True)
    memo = {}

    def solo(dec, params, prompt, max_new, **kw):
        key = (tuple(prompt), int(max_new), tuple(sorted(kw.items())))
        if key not in memo:
            out = jgen.generate_jit(jdec, _jax_params(ref),
                                    jnp.asarray([prompt], jnp.int32),
                                    max_new, **kw)
            memo[key] = np.asarray(out)[0].tolist()
        return list(memo[key])

    ns["_solo"] = solo
    return ref, ns


_PARAMS = {}


def _jax_params(ref):
    """The reference fixture's params at the file's widths (its seed)."""
    V, H, NH, L, MAXLEN = _widths(ref)
    if MAXLEN not in _PARAMS:
        train = JDecoderLM(vocab=V, hidden=H, num_heads=NH, num_layers=L,
                           max_len=MAXLEN, decode=False)
        _PARAMS[MAXLEN] = train.init(
            jax.random.PRNGKey(7),
            jnp.zeros((2, MAXLEN), jnp.int32))["params"]
    return _PARAMS[MAXLEN]


NAMESPACES = {f: _namespace(f) for f in FILES}


def _is_slow(fn):
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", []))


CASES = [(f, name) for f, (ref, _) in NAMESPACES.items()
         for name, fn in vars(ref).items()
         if name.startswith("test_") and inspect.isfunction(fn)
         and not _is_slow(fn) and (f, name) not in LEFT_OUT]


@pytest.fixture(scope="module")
def models():
    """One port model per file's widths, on its JAX params."""
    out = {}
    for filename, (ref, _) in NAMESPACES.items():
        V, H, NH, L, MAXLEN = _widths(ref)
        params = _jax_params(ref)
        if MAXLEN not in out:
            m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L,
                          max_len=MAXLEN)
            m.load_state_dict(convert.from_flax(
                jax.tree.map(np.asarray, params)))
            out[MAXLEN] = (m.eval(), params)
    return out


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.disarm()


def test_every_reference_case_is_collected():
    assert len(CASES) == 47, len(CASES)
    names = {(f, n) for f, (ref, _) in NAMESPACES.items()
             for n in vars(ref) if n.startswith("test_")}
    assert set(LEFT_OUT) <= names


@pytest.mark.parametrize("filename,case", CASES,
                         ids=["{}::{}".format(f[:-3], c) for f, c in CASES])
def test_reference_engine_case_on_the_port(filename, case, models,
                                           request):
    ref, ns = NAMESPACES[filename]
    lm = models[ref.MAXLEN]
    kw = {}
    for name in inspect.signature(ns[case]).parameters:
        kw[name] = lm if name == "lm" else request.getfixturevalue(name)
    ns[case](**kw)


def test_digest_gauges_set_at_construction_and_by_load_stats(models):
    """Both prefix-digest gauges exist from construction on, and
    ``load_stats()`` (what a fleet beat calls) sets them from the digest
    it computes, before anything reads the metrics registry."""
    ref, ns = NAMESPACES["test_paged_kv.py"]
    model, params = models[ref.MAXLEN]
    rng = np.random.RandomState(29)
    prompt = rng.randint(0, ref.V, size=11).tolist()
    engine = ns["serving"].DecodeEngine
    with engine(model, params, slots=2, kv_block_size=8) as eng:
        gauges = eng.counters.snapshot()["gauges"]
        assert gauges["prefix_digest_chains"] == 0
        assert gauges["prefix_digest_truncated"] == 0
        eng.submit(prompt, 13).result(300)
        stats = eng.load_stats()
        gauges = eng.counters.snapshot()["gauges"]
        assert gauges["prefix_digest_chains"] == len(
            stats["prefix_digest"]) == 2
        assert gauges["prefix_digest_truncated"] == 0

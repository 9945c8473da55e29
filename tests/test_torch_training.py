"""The port's training path against the JAX package on the CPU.

- ``DecoderLM``'s full-sequence forward: logits of the port (weights
  converted with ``convert.from_flax``) against the JAX ``DecoderLM.apply``
  at s = 128 (the flash branch) and s = 96 (the plain branch), within
  1e-5 (float32; only the summation order differs).
- ``Trainer``: the JAX ``training.Trainer`` on a one-device mesh and the
  port's, from the same flax init, take the same 4 batches with
  ``adamw(1e-3)``. Per-step losses agree to 1e-4 relative. Final
  parameters agree within 2e-4, except where a gradient is zero in exact
  arithmetic and rounding noise in the other — the attention key bias
  shifts every logit of a row alike, so its gradient is that noise —
  which Adam normalises into steps of up to the learning rate: there
  the bound is one learning rate per step (4e-3). The same holds with
  ``remat=True``.
- ``infeed``: ``prefetch`` order, error re-raise and early close (the
  reference's ``tests/test_training.py`` cases), and ``device_batches``
  copying a reused host buffer.
- ``train_loop``'s goodput envelopes: both trainers charge a custom
  ledger the same kinds in the same order (``compile`` first, then
  ``productive_step``), and ``ledger=False`` charges nothing.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tensorflowonspark_tpu import training as jtraining
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import convert, infeed, training
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

V, H, NH, L, T = 64, 32, 4, 2, 128
LR = 1e-3
STEPS = 4
LOGIT_TOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_TOL = 2e-4
#: a zero-gradient parameter moves by at most ~one learning rate a step
NOISE_PARAM_TOL = STEPS * LR


@pytest.fixture(scope="module")
def flax_params():
    m = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    p = m.init(jax.random.PRNGKey(5), jnp.zeros((1, T), jnp.int32))
    return jax.tree.map(np.asarray, p["params"])


def _port_model(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    m.load_state_dict(convert.from_flax(params))
    return m


@pytest.mark.parametrize("s", [128, 96], ids=["flash_branch", "plain_branch"])
def test_full_sequence_logits_match_reference(flax_params, s):
    tokens = np.random.RandomState(s).randint(0, V, (2, s)).astype(np.int32)
    jm = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    want = np.asarray(jm.apply({"params": flax_params}, tokens))
    model = _port_model(flax_params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, s, V)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_full_sequence_routes_through_flash(flax_params, monkeypatch):
    """s = 128 calls ``flash_attention(causal=True)`` once per block;
    s = 96 takes the plain ``_reference``."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    model = _port_model(flax_params)
    with torch.no_grad():
        model(torch.zeros((1, 128), dtype=torch.int64))
        assert len(calls) == L and all(c["causal"] for c in calls)
        model(torch.zeros((1, 96), dtype=torch.int64))
    assert len(calls) == L
    with pytest.raises(ValueError, match="max_len"):
        model(torch.zeros((1, T + 1), dtype=torch.int64))


def _batches(seed=0, n=STEPS, b=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        row = rng.randint(0, V, (b, T + 1)).astype(np.int32)
        out.append({"x": row[:, :-1], "y": row[:, 1:]})
    return out


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_trainer_matches_reference_trainer(remat):
    batches = _batches()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = jtraining.Trainer(
        JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T),
        optax.adamw(LR), mesh, loss_fn=jtraining.softmax_xent, remat=remat)
    jstate = jt.init(jax.random.PRNGKey(0), batches[0]["x"])
    model = _port_model(jax.tree.map(np.asarray, jstate["params"]))
    tt = training.Trainer(model, training.adamw(LR), remat=remat,
                          device="cpu")
    tstate = tt.init()
    assert tstate["step"] == 0
    for batch in batches:
        jstate, jm = jt.step(jstate, batch)
        tstate, tm = tt.step(tstate, batch)
        want, got = float(jm["loss"]), float(tm["loss"])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    assert tstate["step"] == STEPS
    want = _leaves(jax.tree.map(np.asarray, jstate["params"]))
    got = _leaves(convert.to_flax(model.state_dict(), NH))
    assert set(got) == set(want)
    for path, w in want.items():
        tol = (NOISE_PARAM_TOL if "'attn']['key']['bias']" in path
               else PARAM_TOL)
        err = np.abs(got[path] - w).max()
        assert err <= tol, (path, err)


def test_softmax_xent_matches_reference():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 5, V).astype(np.float32)
    y = rng.randint(0, V, (3, 5)).astype(np.int32)
    want = float(jtraining.softmax_xent(jnp.asarray(logits), {"y": y}))
    got = float(training.softmax_xent(torch.from_numpy(logits),
                                      {"y": torch.from_numpy(y)}))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_adamw_matches_optax_defaults():
    """One parameter group, optax's betas/eps/weight decay (1e-4)."""
    rng = np.random.RandomState(2)
    p0 = rng.randn(7, 3).astype(np.float32)
    grads = [rng.randn(7, 3).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(1e-2)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = training.adamw(1e-2)([tp])
    assert len(opt.param_groups) == 1
    assert opt.param_groups[0]["weight_decay"] == 1e-4
    for g in grads:
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-6, rtol=1e-6)


def test_input_keys_binding_and_missing_middle_key():
    class Two(torch.nn.Module):
        def __init__(self):
            super(Two, self).__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, a, b=None):
            return self.w * (a if b is None else a + b)

    tr = training.Trainer(Two(), training.adamw(0.1), input_keys=("a", "b"),
                          loss_fn=lambda out, batch: out.sum(),
                          device="cpu")
    assert tr._inputs({"a": 1, "b": 2}) == (1, 2)
    assert tr._inputs({"a": 1}) == (1,)  # trailing key may be absent
    with pytest.raises(KeyError, match="missing input key 'a'"):
        tr._inputs({"b": 2})
    state = tr.init()
    state, m = tr.step(state, {"a": np.ones(3, np.float32)})
    assert float(m["loss"]) == 3.0 and state["step"] == 1


def test_train_loop_returns_steps_rate_and_runs_hooks(flax_params):
    model = _port_model(flax_params)
    tr = training.Trainer(model, training.adamw(LR), device="cpu")
    state = tr.init()
    seen = []
    state, n, rate = tr.train_loop(
        state, iter(_batches(n=3)), log_every=2,
        hooks=[lambda i, s, m: seen.append((i, float(m["loss"])))])
    assert n == 3 and rate > 0 and [i for i, _ in seen] == [1, 2, 3]
    assert state["step"] == 3


def test_train_loop_charges_the_reference_envelopes(flax_params):
    from tensorflowonspark_tpu import goodput as jgoodput
    from tensorflowonspark_tpu import tracing as jtracing
    from tensorflowonspark_tpu_torch import goodput, tracing

    batches = _batches(n=3)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = jtraining.Trainer(
        JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T),
        optax.adamw(LR), mesh, loss_fn=jtraining.softmax_xent)
    jstate = jt.init(jax.random.PRNGKey(0), batches[0]["x"])
    jflight = jtracing.FlightRecorder()
    jled = jgoodput.GoodputLedger(flight=jflight)
    jt.train_loop(jstate, iter(batches), log_every=0, ledger=jled)
    want = [e["name"] for e in jflight.events()]

    tt = training.Trainer(_port_model(flax_params), training.adamw(LR),
                          device="cpu")
    flight = tracing.FlightRecorder()
    led = goodput.GoodputLedger(flight=flight)
    tt.train_loop(tt.init(), iter(batches), log_every=0, ledger=led)
    names, rep = [e["name"] for e in flight.events()], led.report()
    assert names == want == ["compile", "train_step", "train_step"]
    jrep = jled.report()
    assert rep["steps"] == jrep["steps"] == 2
    assert rep["badput"]["compile"] > 0 and rep["productive_s"] > 0
    assert set(rep) == set(jrep)

    goodput.reset()
    try:
        process = goodput.ledger()
        before = process.report()
        tt.train_loop(tt.init(), iter(batches), log_every=0, ledger=False)
        after = process.report()
        assert after["steps"] == before["steps"] == 0
        assert after["badput"]["compile"] == 0.0
        assert after["productive_s"] == 0.0
    finally:
        goodput.reset()


def test_trainer_init_from_generator_and_without_card():
    model = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    tr = training.Trainer(model, training.adamw(LR), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    first = model.tok_embed.weight.detach().clone()
    tr.init(torch.Generator().manual_seed(0))
    assert torch.equal(first, model.tok_embed.weight)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            training.Trainer(model, training.adamw(LR))


def test_prefetch_order_and_error():
    batches = [np.full((2,), i) for i in range(5)]
    out = list(infeed.prefetch(iter(batches), size=2))
    assert [int(b[0]) for b in out] == [0, 1, 2, 3, 4]
    assert all(torch.is_tensor(b) for b in out)

    def boom():
        yield np.zeros((2,))
        raise ValueError("stage boom")

    it = infeed.prefetch(boom(), size=2)
    next(it)
    with pytest.raises(ValueError, match="stage boom"):
        next(it)


def test_prefetch_early_close_joins_staging_thread():
    produced = [0]

    def endless():
        while True:
            produced[0] += 1
            yield np.zeros((2,))

    it = infeed.prefetch(endless(), size=2)
    next(it)
    it.close()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if not any(t.name == "infeed-prefetch" and t.is_alive()
                   for t in threading.enumerate()):
            break
        time.sleep(0.05)
    leaked = [t.name for t in threading.enumerate()
              if t.name == "infeed-prefetch" and t.is_alive()]
    assert not leaked, leaked
    n = produced[0]
    time.sleep(0.2)
    assert produced[0] == n


def test_device_batches_copies_a_reused_buffer():
    """A feed that refills one host buffer per batch: every staged batch
    keeps the values it had when it was produced."""
    buf = {"x": np.zeros((2, 3), np.int32), "y": np.zeros((2,), np.int64)}

    def refill():
        for i in range(6):
            buf["x"][:] = i
            buf["y"][:] = 10 * i
            yield buf

    got = list(infeed.device_batches(refill(), device="cpu", size=3))
    assert [int(b["x"][0, 0]) for b in got] == list(range(6))
    assert [int(b["y"][1]) for b in got] == [10 * i for i in range(6)]
    assert all(b["x"].dtype == torch.int32 for b in got)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infeed.device_batches(refill())

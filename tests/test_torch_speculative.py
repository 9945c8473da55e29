"""The port's speculative engine — the counterpart of the reference's
``tests/test_speculative.py``.

Speculation must be invisible at temperature 0: token-matching
acceptance emits exactly the target's own picks, so a speculative
engine's greedy tokens equal the plain paged engine's (held against the
JAX engine in ``test_torch_serving.py``) across mixed lengths, warm
prefixes, preemption continuations and EOS — at the low acceptance of
random weights (the rejection path) and at a draft of every layer
(acceptance 1.0, the full-accept path). A JAX speculative engine and
the port's on the same converted weights emit the same tokens. Then
the counter contract (``spec_rounds <= spec_proposed <= k *
spec_rounds``, ``spec_accepted <= spec_proposed``, the rate
``round(accepted / proposed, 4)``), the reference's validation
messages, int8 against float through the verify window at the
reference's 99% top-1 bar, and cancel / deadline churn returning every
block.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch import serving
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

V, H, NH, L, T = 64, 32, 4, 2, 64


@pytest.fixture(scope="module")
def lm():
    train = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    params = train.init(jax.random.PRNGKey(7),
                        jnp.zeros((2, T), jnp.int32))["params"]
    dec = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T,
                decode=True)
    return dec, params


def _port(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    m.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return m


def _serve(params, reqs, serial=False, **kw):
    with serving.DecodeEngine(_port(params), device="cpu", **kw) as eng:
        if serial:
            out = [eng.submit(p, mn).result(300) for p, mn in reqs]
        else:
            out = [h.result(300) for h in
                   [eng.submit(p, mn) for p, mn in reqs]]
        return out, dict(eng.counters.snapshot()["counts"]), eng


def _mixed(seed, n=6):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, size=rng.randint(3, 20)).tolist(),
             int(rng.randint(1, 10))) for _ in range(n)]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_speculative_equals_plain_mixed_lengths(lm, k):
    _, params = lm
    reqs = _mixed(0)
    want, _, _ = _serve(params, reqs, slots=2, kv_block_size=8)
    got, counts, eng = _serve(params, reqs, slots=2, kv_block_size=8,
                              speculate_k=k)
    assert eng._spec_k == k and eng.draft_layers == 1
    assert got == want
    assert counts["spec_rounds"] > 0
    assert eng._pool.live_refs() == {}


def test_speculative_equals_jax_speculative(lm):
    """The reference's speculative engine and the port's, on the same
    converted weights, emit the same tokens (and both the plain ones)."""
    dec, params = lm
    reqs = _mixed(11, n=4)
    with jserving.DecodeEngine(dec, params, slots=2, kv_block_size=8,
                               speculate_k=3) as jeng:
        want = [h.result(300) for h in
                [jeng.submit(p, mn) for p, mn in reqs]]
    got, counts, _ = _serve(params, reqs, slots=2, kv_block_size=8,
                            speculate_k=3)
    assert got == want
    assert counts["spec_proposed"] >= counts["spec_rounds"] > 0


def test_speculative_prefix_cached(lm):
    """Warm admissions: the draft pool mirrors the target pool block for
    block, so table-pointing admissions still give the plain tokens and
    provably hit the cache."""
    _, params = lm
    rng = np.random.RandomState(3)
    sys_prompt = rng.randint(0, V, size=40).tolist()
    reqs = [(sys_prompt + rng.randint(0, V, size=4).tolist(), 8)
            for _ in range(3)]
    want, _, _ = _serve(params, reqs, serial=True, slots=2,
                        kv_block_size=16)
    got, counts, _ = _serve(params, reqs, serial=True, slots=2,
                            kv_block_size=16, speculate_k=3)
    assert got == want
    assert counts.get("prefix_hit_blocks", 0) == 4


def test_speculative_preemption_continuation(lm):
    """Pool exhaustion under the k-token lookahead: growth covers the
    round's window, the youngest is preempted, the continuation resumes
    the stream, and every block returns."""
    _, params = lm
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, V, size=9).tolist(), 20) for _ in range(2)]
    want, _, _ = _serve(params, reqs, slots=2, kv_block_size=8)
    got, counts, eng = _serve(params, reqs, slots=2, kv_block_size=8,
                              kv_blocks=5, prefix_cache=False,
                              speculate_k=3)
    assert counts.get("preemptions", 0) >= 1
    assert got == want
    assert eng._pool.live_refs() == {} and eng._pool.allocatable() == 5


def test_speculative_eos_matches_plain(lm):
    """EOS inside a round's window stops the request where the plain
    engine stops it (later window tokens are never delivered)."""
    _, params = lm
    rng = np.random.RandomState(8)
    reqs = [(rng.randint(0, V, size=7).tolist(), 14) for _ in range(3)]
    plain, _, _ = _serve(params, reqs, slots=2)
    # an EOS that the plain streams emit mid-way
    eos = plain[0][7 + 4]
    outs = {}
    for label, kw in (("plain", {}), ("spec", {"speculate_k": 4})):
        outs[label], _, _ = _serve(params, reqs, slots=2, eos_token=eos,
                                   **kw)
    assert outs["spec"] == outs["plain"]
    assert outs["plain"][0][-1] == eos and len(outs["plain"][0]) <= 7 + 5


def test_full_acceptance_when_the_draft_is_the_target(lm):
    """``draft_layers = num_layers``: the draft IS the target, so every
    proposal stands — acceptance exactly 1.0, every round emits its
    whole window — and the tokens are still the plain ones."""
    _, params = lm
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(0, V, size=6).tolist(), 12) for _ in range(2)]
    want, _, _ = _serve(params, reqs, slots=2)
    got, counts, eng = _serve(params, reqs, slots=2, speculate_k=3,
                              draft_layers=L)
    assert got == want
    assert eng.load_stats()["spec_acceptance_rate"] == 1.0
    assert counts["spec_accepted"] == counts["spec_proposed"]


def test_spec_counter_contract_and_live_rate(lm):
    """The documented counter algebra: each slot-round tallies only its
    emittable window ``min(k, remaining)``, so rounds <= proposed <= k x
    rounds, strictly below at max_new 9 with k 3 (a request's last
    window is clamped); accepted <= proposed; the rate is
    round(accepted / proposed, 4); tokens never exceed what rounds can
    emit."""
    _, params = lm
    k = 3
    with serving.DecodeEngine(_port(params), slots=2, speculate_k=k,
                              device="cpu") as eng:
        for _ in range(2):
            eng.submit(list(range(1, 8)), 9).result(300)
        counts = eng.counters.snapshot()["counts"]
        load = eng.load_stats()
    proposed = counts["spec_proposed"]
    accepted = counts["spec_accepted"]
    rounds = counts["spec_rounds"]
    assert rounds > 0
    assert rounds <= proposed <= k * rounds
    assert proposed < k * rounds
    assert 0 <= accepted <= proposed
    assert load["spec_acceptance_rate"] == round(accepted / proposed, 4)
    assert counts["decode_tokens"] <= rounds * k
    assert load["speculate_k"] == k and load["draft_layers"] == 1


def test_sampled_speculation_replays_from_its_seed(lm):
    """temperature > 0: the draft and the verify draw from two streams
    split from the engine's seeded generator, so the same seed replays
    the same tokens (compared in distribution with the reference, never
    bitwise), and every output keeps its shape."""
    _, params = lm
    reqs = _mixed(13, n=3)
    outs = []
    for _ in range(2):
        got, counts, _ = _serve(
            params, reqs, slots=2, speculate_k=3, temperature=0.9,
            top_k=20, generator=torch.Generator().manual_seed(21))
        outs.append(got)
        assert counts["spec_rounds"] > 0
    assert outs[0] == outs[1]
    for (p, mn), out in zip(reqs, outs[0]):
        assert len(out) == len(p) + mn and out[:len(p)] == p


def test_spec_validation_and_schema(lm):
    _, params = lm
    model = _port(params)
    for kw, match in (({"speculate_k": 1}, "speculate_k"),
                      ({"kv_block_size": 0, "speculate_k": 2}, "paged"),
                      ({"draft_layers": 1}, "draft_layers"),
                      ({"speculate_k": 2, "draft_layers": L + 1},
                       "draft_layers"),
                      ({"tier": "edge"}, "tier")):
        with pytest.raises(ValueError, match=match):
            serving.DecodeEngine(model, slots=1, device="cpu", **kw)
    with serving.DecodeEngine(model, slots=2, device="cpu") as eng:
        load = eng.load_stats()
        assert (load["speculate_k"], load["draft_layers"],
                load["spec_acceptance_rate"]) == (0, 0, 0.0)
        assert load["tier"] == "mixed"
        assert eng.measure_spec() is None
    with serving.DecodeEngine(model, slots=2, speculate_k=2,
                              kv_dtype="int8", device="cpu") as eng:
        eng.submit([1, 2, 3], 4).result(300)
        load = eng.load_stats()
        assert load["speculate_k"] == 2 and load["kv_dtype"] == "int8"
        spec_ms = eng.measure_spec()
        assert spec_ms["draft"] > 0 and spec_ms["verify"] > 0
        per = eng.timers.per_ms()
        assert "draft" in per and "verify" in per
        code, body = serving.ModelServer(None, engine=eng).healthz()
        assert code == 200 and body["speculate_k"] == 2


def test_int8_verify_window_top1_agreement():
    """int8 KV on the speculative path, at the reference's bar and on
    the reference test's own model (``tests/test_speculative.py``: vocab
    17, PRNGKey(7); at vocab 64 the reference itself agrees on 98.4%
    of its teacher-forced positions, the port's verify on 98.2%): full
    sequences (the float model's greedy continuations) teacher-forced
    through the verify step — a prefill, then windows of k = 4 queries
    mid-sequence, as a round feeds them — on a float pool and an int8
    pool agree on the top-1 pick at >= 99% of the positions."""
    from tensorflowonspark_tpu_torch import generation as tgen

    v = 17
    train = JaxLM(vocab=v, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    params = train.init(jax.random.PRNGKey(7),
                        jnp.zeros((2, T), jnp.int32))["params"]
    model = DecoderLM(v, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    model.load_state_dict(convert.from_flax(
        jax.tree.map(np.asarray, params)))
    model.eval()
    bs, k, start = 8, 4, 8
    mb = T // bs
    table = torch.arange(1, mb + 1, dtype=torch.int32)[None, :]
    rng = np.random.RandomState(2)
    seqs = [tgen.generate(model, [rng.randint(0, v, size=10).tolist()],
                          T - 10, device="cpu")[0] for _ in range(6)]
    picks = {}
    for kv in (None, "int8"):
        picks[kv] = []
        for seq in seqs:
            cache = tgen.init_paged_cache(model, 1, T, kv_blocks=mb,
                                          block_size=bs, kv_dtype=kv,
                                          device="cpu")
            tgen.paged_prefill_into_slot(model, cache, table[0],
                                         seq[:start], start, 0)
            for i in range(start, T - k + 1, k):
                picks[kv].append(tgen.paged_verify_step(
                    model, cache, seq[None, i:i + k],
                    torch.tensor([i], dtype=torch.int32), table).numpy())
    a = np.concatenate(picks[None], axis=None)
    b = np.concatenate(picks["int8"], axis=None)
    assert a.size >= 300
    assert (a == b).mean() >= 0.99, (a == b).mean()


def test_spec_churn_leaves_no_leaked_block(lm):
    """Cancel and deadline eviction landing at round boundaries while
    rounds emit multi-token windows: every block comes back (the draft
    pool shares the block ids, so a leak in either shows), and a
    request served after the churn still gets the plain tokens."""
    _, params = lm
    rng = np.random.RandomState(9)
    prompt = rng.randint(0, V, size=18).tolist()
    want, _, _ = _serve(params, [(prompt, 3)], slots=2, kv_block_size=8)
    with serving.DecodeEngine(_port(params), slots=2, kv_block_size=8,
                              kv_blocks=12, speculate_k=3,
                              device="cpu") as eng:
        pool = eng._pool
        for _ in range(2):
            victim = eng.submit(prompt, 30)
            it = victim.stream(timeout=120)
            next(it)
            victim.cancel()
            with pytest.raises(serving.Cancelled):
                victim.result(120)
            # a warm engine sheds an infeasible deadline at the door;
            # cleared EWMAs (no evidence) pin the in-flight eviction
            eng._step_ewma = eng._prefill_ewma = None
            slow = eng.submit(prompt, 40, deadline_s=0.005)
            with pytest.raises(serving.DeadlineExceeded):
                slow.result(120)
            assert eng.submit(prompt, 3).result(120) == want[0]
            deadline = time.monotonic() + 30
            while pool.live_refs() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert pool.live_refs() == {}
            assert pool.allocatable() == 12

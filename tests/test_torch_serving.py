"""The port's ``DecodeEngine`` and ``ModelServer`` against the JAX
reference.

Both engines serve the same flax params (the port's through
``convert.from_flax``) at temperature 0 on the CPU, and must emit
IDENTICAL tokens for the cases the reference pins among its own
engines (tests/test_paged_kv.py): mixed prompt lengths, a shared-prefix
pair served warm, and preemption under a small pool — with the
prefix-hit and preemption counters moving in both, and the contiguous
(``kv_block_size=0``) engine. int8 KV keeps the
reference's >= 99% teacher-forced top-1 agreement, the gather oracle
equals the fused path, the HTTP surface answers over a real socket, and
an engine never falls back to the CPU on its own.
"""

import http.client
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch import generation as tgen
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


def _serve(engine, reqs, serial=False):
    with engine as eng:
        if serial:
            out = [eng.submit(p, mn).result(300) for p, mn in reqs]
        else:
            out = [h.result(300) for h in
                   [eng.submit(p, mn) for p, mn in reqs]]
        return out, dict(eng.counters.snapshot()["counts"]), eng


def _both(lm, reqs, serial=False, **kw):
    dec, params = lm
    want, jcounts, _ = _serve(jserving.DecodeEngine(dec, params, **kw),
                              reqs, serial)
    got, tcounts, eng = _serve(
        serving.DecodeEngine(_port(params), device="cpu", **kw), reqs,
        serial)
    return want, got, jcounts, tcounts, eng


def test_mixed_lengths_identical_tokens(lm):
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, V, size=rng.randint(3, 20)).tolist(),
             int(rng.randint(1, 10))) for _ in range(6)]
    want, got, _, tcounts, eng = _both(lm, reqs, slots=2, kv_block_size=8)
    assert got == want
    assert tcounts["requests_completed"] == 6
    # every block came back
    assert eng._pool.live_refs() == {}
    assert eng.load_stats()["kv_blocks_free"] == eng.kv_blocks


def test_block_size_64_identical_tokens(lm):
    """A block size above 32 (one 64-token block per row at total_len
    64) serves as the reference's engine does: the port's split and
    tensor-core tiled routes take any block size."""
    rng = np.random.RandomState(64)
    reqs = [(rng.randint(0, V, size=rng.randint(3, 30)).tolist(),
             int(rng.randint(2, 12))) for _ in range(4)]
    want, got, _, tcounts, eng = _both(lm, reqs, slots=2, kv_block_size=64)
    assert got == want
    assert eng.kv_block_size == 64
    assert tcounts["requests_completed"] == 4
    assert eng._pool.live_refs() == {}


def test_shared_prefix_hits_identical_tokens(lm):
    rng = np.random.RandomState(3)
    sys_prompt = rng.randint(0, V, size=20).tolist()  # 2 full 8-blocks
    reqs = [(sys_prompt + rng.randint(0, V, size=4).tolist(), 8)
            for _ in range(2)]
    want, got, jcounts, tcounts, _ = _both(lm, reqs, serial=True, slots=2,
                                           kv_block_size=8)
    assert got == want
    assert tcounts.get("prefix_hit_blocks", 0) == 2
    assert jcounts.get("prefix_hit_blocks", 0) == 2


def test_preemption_identical_tokens(lm):
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, V, size=9).tolist(), 20) for _ in range(2)]
    # each request grows to ceil(29/8) = 4 blocks; two need 8 > 5
    want, got, jcounts, tcounts, eng = _both(
        lm, reqs, slots=2, kv_block_size=8, kv_blocks=5,
        prefix_cache=False)
    assert got == want
    assert tcounts.get("preemptions", 0) >= 1
    assert jcounts.get("preemptions", 0) >= 1
    assert eng._pool.live_refs() == {} and eng._pool.allocatable() == 5


def test_contiguous_engine_identical_tokens(lm):
    """``kv_block_size=0``: the contiguous per-slot cache (no pool) emits
    the reference's contiguous engine's tokens, which equal the paged
    engine's; the zero schema rides ``load_stats``."""
    rng = np.random.RandomState(12)
    reqs = [(rng.randint(0, V, size=rng.randint(3, 30)).tolist(),
             int(rng.randint(1, 12))) for _ in range(5)]
    want, got, jcounts, tcounts, eng = _both(lm, reqs, slots=2,
                                             kv_block_size=0)
    assert got == want
    assert tcounts["requests_completed"] == 5 == jcounts[
        "requests_completed"]
    paged, _, _ = _serve(serving.DecodeEngine(
        _port(lm[1]), slots=2, kv_block_size=8, device="cpu"), reqs)
    assert paged == got
    load = eng.load_stats()
    assert eng._pool is None and eng.attn_impl == "contiguous"
    assert (load["attn_impl"], load["kv_blocks_total"], load["kv_dtype"],
            load["speculate_k"]) == ("contiguous", 0, "float32", 0)


def test_contiguous_engine_refuses_pool_options(lm):
    """The reference's messages: pool options need a paged engine."""
    _, params = lm
    for kw, match in (({"kv_blocks": 4}, "kv_blocks needs a paged"),
                      ({"attn_impl": "fused"}, "attn_impl needs a paged"),
                      ({"kv_dtype": "int8"}, "int8.*needs a paged"),
                      ({"speculate_k": 2}, "speculate_k needs a paged")):
        with pytest.raises(ValueError, match=match):
            serving.DecodeEngine(_port(params), slots=1, kv_block_size=0,
                                 device="cpu", **kw)


def test_gather_equals_fused_and_int8_serves(lm):
    _, params = lm
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(0, V, size=rng.randint(3, 30)).tolist(), 12)
            for _ in range(4)]
    outs = {}
    for impl, kv in (("fused", None), ("gather", None), ("fused", "int8"),
                     ("gather", "int8")):
        outs[impl, kv], _, eng = _serve(serving.DecodeEngine(
            _port(params), slots=3, kv_block_size=8, attn_impl=impl,
            kv_dtype=kv, device="cpu"), reqs)
        assert eng.load_stats()["kv_dtype"] == (kv or "float32")
    assert outs["gather", None] == outs["fused", None]
    assert outs["gather", "int8"] == outs["fused", "int8"]
    for out, (p, mn) in zip(outs["fused", "int8"], reqs):
        assert len(out) == len(p) + mn and out[:len(p)] == p


def test_int8_top1_agreement_teacher_forced(lm):
    """Teacher-forced top-1 agreement >= 99% between the float and int8
    paged paths, through the real write (quantize) and read (dequant)
    code, at every position of full sequences."""
    _, params = lm
    model = _port(params).eval()
    bs, mb = 8, T // 8
    table = torch.arange(1, mb + 1, dtype=torch.int32)[None, :]
    rng = np.random.RandomState(2)
    seqs = [torch.as_tensor(rng.randint(0, V, size=(1, T)),
                            dtype=torch.int32) for _ in range(6)]
    argmaxes = {}
    with torch.no_grad():
        for kv in (None, "int8"):
            argmaxes[kv] = []
            for seq in seqs:
                cache = tgen.init_paged_cache(model, 1, T, kv_blocks=mb,
                                              block_size=bs, kv_dtype=kv,
                                              device="cpu")
                logits = model(seq, cache, torch.zeros(1, dtype=torch.int32),
                               table)
                argmaxes[kv].append(logits.argmax(-1).numpy())
    a = np.concatenate(argmaxes[None], axis=None)
    b = np.concatenate(argmaxes["int8"], axis=None)
    assert a.size >= 300
    assert (a == b).mean() >= 0.99


def test_sampling_helpers_follow_reference():
    """top-k / nucleus masking equals the reference's on the same
    logits (ties included), and a seeded generator gives a reproducible
    sampled stream whose draws follow the distribution."""
    from tensorflowonspark_tpu import generation as jgen

    rng = np.random.RandomState(6)
    logits = rng.randn(4, 64).astype(np.float32)
    logits[0, [3, 9, 20]] = logits[0].max() + 1.0  # a three-way tie
    for kw in ({"top_k": 5}, {"top_p": 0.7}, {"top_k": 8, "top_p": 0.5},
               {"top_p": 0.3, "temperature": 0.5}):
        want = np.asarray(jgen.filter_logits(jnp.asarray(logits), **kw))
        got = tgen.filter_logits(torch.from_numpy(logits), **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
    with pytest.raises(ValueError):
        tgen.check_sampling_config(1.0, None, None, None)
    with pytest.raises(ValueError):
        tgen.check_sampling_config(0.0, 0, None, None)
    two = torch.tensor([[0.0, np.log(3.0)]]).repeat(4000, 1)
    draws = [tgen._pick_tokens(two, torch.Generator().manual_seed(4), 1.0,
                               None, None) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    # P(token 1) = 3/4; 4000 draws put the mean within +-0.03 (4 sigma)
    assert abs(draws[0].float().mean().item() - 0.75) < 0.03
    assert tgen.bucket_for(9, tgen.default_buckets(64)) == 16


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    conn.request("POST", path, body=raw,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_model_server_generate_over_http(lm):
    dec, params = lm
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, V, size=n).tolist() for n in (5, 11)]
    with jserving.DecodeEngine(dec, params, slots=2) as jeng:
        want = [jeng.generate(p, 6, timeout=300) for p in prompts]
    eng = serving.DecodeEngine(_port(params), slots=2, device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0, engine=eng) as srv:
        port = srv.address[1]
        path = "/v1/models/lm:generate"
        assert _post(port, path, {"prompt": prompts,
                                  "max_new_tokens": 6}) == \
            (200, {"tokens": want})
        assert _post(port, path, {"prompt": prompts[0],
                                  "max_new_tokens": 6}) == \
            (200, {"tokens": want[0]})
        assert _post(port, path, b"{not json")[0] == 400
        assert _post(port, path, {"prompt": [V + 3]})[0] == 400
        assert _post(port, path, {"max_new_tokens": 2})[0] == 400
        assert _post(port, "/v1/models/other:generate",
                     {"prompt": [1]})[0] == 404
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["status"] == "ok"
        assert body["device"] == "cpu" and body["attn_impl"] == "fused"


def test_queue_full_is_429_over_http(lm):
    _, params = lm
    eng = serving.DecodeEngine(_port(params), slots=1, max_queue=0,
                               device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0, engine=eng) as srv:
        status, body = _post(srv.address[1], "/v1/models/lm:generate",
                             {"prompt": [1, 2], "max_new_tokens": 2})
    assert status == 429 and "queue full" in body["error"]


def test_sampled_engine_reproducible_from_seed(lm):
    """temperature > 0 draws from the engine's seeded generator: the same
    seed and traffic replay the same stream (compared with the port
    itself — the reference's PRNG gives other draws by construction)."""
    _, params = lm
    outs = []
    for _ in range(2):
        eng = serving.DecodeEngine(
            _port(params), slots=1, temperature=0.9, top_k=20, top_p=0.9,
            generator=torch.Generator().manual_seed(11), device="cpu")
        with eng:
            outs.append([eng.generate(p, 10, timeout=120)
                         for p in ([1, 2, 3], [4, 5])])
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="Generator"):
        serving.DecodeEngine(_port(params), temperature=0.5, device="cpu")


def test_request_lifecycle_frees_slots(lm):
    """Streaming yields the same tokens as ``result``; an abandoned
    stream cancels its request and a passed deadline evicts it, both at
    a step boundary with every block returned; ``max_new_tokens=0``
    answers inline with the prompt."""
    _, params = lm
    with serving.DecodeEngine(_port(params), slots=2, kv_block_size=8,
                              device="cpu") as eng:
        whole = eng.generate([3, 1, 4, 1, 5], 6, timeout=120)
        streamed = list(eng.submit([3, 1, 4, 1, 5], 6).stream(timeout=120))
        assert [3, 1, 4, 1, 5] + streamed == whole
        h = eng.submit([2, 7, 1], 50)
        it = h.stream(timeout=120)
        next(it)
        it.close()  # the consumer walked away
        with pytest.raises(serving.Cancelled):
            h.result(120)
        # a warm engine sheds an infeasible deadline at the door;
        # cleared EWMAs (no evidence) pin the in-flight eviction
        eng._step_ewma = eng._prefill_ewma = None
        late = eng.submit([9, 9], 50, deadline_s=1e-3)
        with pytest.raises(serving.DeadlineExceeded):
            late.result(120)
        assert eng.submit([5], 0).result(1) == [5]
        # the scheduler releases an evicted slot just after failing its
        # handle: poll, bounded
        deadline = time.monotonic() + 30
        while True:
            counts = eng.counters.snapshot()["counts"]
            done = (counts.get("cancelled") == 1
                    and counts.get("deadline_exceeded") == 1
                    and eng._pool.live_refs() == {}
                    and eng.load_stats()["slot_occupancy"] == 0)
            if done or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert done, (counts, eng._pool.live_refs())
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1], 1)


def test_device_discovery(monkeypatch):
    from tensorflowonspark_tpu_torch import device_info

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert device_info.get_devices() == ["0", "1", "2"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5, 7")
    assert device_info.get_devices(2) == ["5", "7"]
    with pytest.raises(RuntimeError, match="requested 4"):
        device_info.get_devices(4)
    assert device_info.default_device("cpu") == torch.device("cpu")


def test_engine_refuses_to_run_on_cpu_unasked(lm, monkeypatch):
    """With no card and no explicit device, the engine raises instead of
    quietly serving on the CPU (forced here even on a machine that has
    a card)."""
    _, params = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.DecodeEngine(_port(params), slots=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.DecodeEngine(_port(params), slots=1, device="cuda")

"""The port's ``ModelServer(model_dir)`` ``:predict`` path with its
batching window, against the JAX package's server, on the CPU.

A converted ``bert_tiny`` QA model is exported with the port's
``export.save_model`` (its ``apply_fn`` builds a ``meta`` skeleton) and
served: the row and columnar request formats, the 400 taxonomy, the
window's coalescing (apply calls counted, rows unchanged), signatures
kept apart, ``max_batch``, ``stop``, the model routes, and the same
weights served by both packages giving the same JSON. The reference's
constructor signature holds, and an engine-only server still serves
``:generate``.
"""

import http.client
import inspect
import json
import threading

import numpy as np
import pytest
import torch

import jax

from tensorflowonspark_tpu import export as jexport
from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu.models import bert as jbert
from tensorflowonspark_tpu_torch import convert, export, serving
from tensorflowonspark_tpu_torch.models import bert
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

KEYS = ("input_ids", "attention_mask", "token_type_ids")
#: a row's outputs alone and inside a merged batch: the same float32
#: products per row, where only the matmul's blocking over the batch may
#: change a summation order (~1e-7 relative)
GROUP_RTOL = 1e-5
#: the port's served logits against the JAX package's served logits on
#: the same converted weights, float32 (two layers of products in other
#: summation orders)
SERVE_RTOL = 1e-4
S = 32


def make_apply_fn(cfg_kwargs):
    """The export's ``apply_fn``: a ``meta`` skeleton of the QA model
    called on the loaded variables (nested, so it ships by value)."""

    def apply_fn(variables, batch):
        import torch

        from tensorflowonspark_tpu_torch.models import bert as _bert

        skeleton = _bert.BertForQuestionAnswering(
            _bert.BertConfig(**cfg_kwargs), device="meta").eval()
        dev = next(iter(variables.values())).device
        inputs = tuple(torch.as_tensor(batch[k], device=dev)
                       for k in KEYS if k in batch)
        start, end = torch.func.functional_call(skeleton, variables, inputs)
        return {"start_logits": start, "end_logits": end}

    return apply_fn


def _cfg_kwargs():
    c = bert.bert_tiny()
    return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                num_layers=c.num_layers, num_heads=c.num_heads,
                intermediate_size=c.intermediate_size,
                max_position=c.max_position, dtype=torch.float32)


@pytest.fixture(scope="module")
def flax_params():
    cfg = jbert.bert_tiny()
    cfg.dtype = jax.numpy.float32
    ids = np.zeros((1, S), np.int32)
    params = jbert.BertForQuestionAnswering(cfg).init(
        jax.random.PRNGKey(0), ids)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory, flax_params):
    d = str(tmp_path_factory.mktemp("predict") / "bert_tiny")
    export.save_model(d, make_apply_fn(_cfg_kwargs()),
                      convert.bert_from_flax(flax_params),
                      signature={"inputs": list(KEYS),
                                 "outputs": ["start_logits",
                                             "end_logits"]})
    return d


@pytest.fixture(scope="module")
def model(flax_params):
    m = bert.BertForQuestionAnswering(bert.BertConfig(**_cfg_kwargs()))
    m.load_state_dict(convert.bert_from_flax(flax_params))
    return m.eval()


def _rows(n, seed, s=S):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        length = int(rng.randint(s // 2, s + 1))
        rows.append({"input_ids": rng.randint(0, 1024, s).tolist(),
                     "attention_mask": [i < length for i in range(s)],
                     "token_type_ids": [0] * (s // 2) + [1] * (s - s // 2)})
    return rows


def _want(model, rows):
    cols = [torch.tensor([r[k] for r in rows]) for k in KEYS]
    with torch.no_grad():
        start, end = model(*cols)
    return start.numpy(), end.numpy()


def _rel(got, want):
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _post(port, name, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/models/%s:predict" % name,
                 body=body if isinstance(body, bytes)
                 else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_the_references_signature():
    ours = list(inspect.signature(serving.ModelServer).parameters.values())
    ref = list(inspect.signature(jserving.ModelServer).parameters.values())
    assert [(p.name, p.default) for p in ours[:6]] == \
        [(p.name, p.default) for p in ref[:6]]
    assert [p.name for p in ours[:6]] == [
        "model_dir", "name", "host", "port", "batch_window_ms", "engine"]
    with pytest.raises(ValueError):
        serving.ModelServer(None)


def test_engine_only_server_serves_generate_and_refuses_predict():
    model = DecoderLM(32, hidden=16, num_heads=2, num_layers=1, max_len=32)
    model.init_weights(torch.Generator().manual_seed(0))
    eng = serving.DecodeEngine(model, slots=2, device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0,
                                  engine=eng) as srv:
        port = srv.address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/models/lm:generate",
                     body=json.dumps({"prompt": [1, 2, 3],
                                      "max_new_tokens": 3}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["tokens"][:3] == [1, 2, 3]
        assert len(body["tokens"]) == 6
        status, body = _post(port, "lm", {"instances": [[1, 2]]})
        assert status == 400 and "no exported model" in body["error"]
        assert _get(port, "/healthz")[0] == 200


@pytest.mark.parametrize("window_ms", [0, 5])
def test_row_and_columnar_formats_match_the_model(export_dir, model,
                                                  window_ms):
    rows = _rows(3, seed=1)
    start, end = _want(model, rows)
    with serving.ModelServer(export_dir, name="qa", port=0, device="cpu",
                             batch_window_ms=window_ms) as srv:
        port = srv.address[1]
        status, body = _post(port, "qa", {"instances": rows})
        assert status == 200
        preds = body["predictions"]
        assert len(preds) == 3
        assert _rel([p["start_logits"] for p in preds], start) <= 1e-6
        assert _rel([p["end_logits"] for p in preds], end) <= 1e-6
        cols = {k: [r[k] for r in rows] for k in KEYS}
        status, body = _post(port, "qa", {"inputs": cols})
        assert status == 200
        assert _rel(body["outputs"]["start_logits"], start) <= 1e-6
        assert _rel(body["outputs"]["end_logits"], end) <= 1e-6
        status, meta = _get(port, "/v1/models/qa/metadata")
        assert status == 200
        assert meta["metadata"]["signature_def"]["inputs"] == list(KEYS)
        assert meta["metadata"]["format"] == "tfos-torch-export-v1"
        status, st = _get(port, "/v1/models/qa")
        assert st["model_version_status"][0]["state"] == "AVAILABLE"
        assert _get(port, "/healthz")[0] == 200
        assert _get(port, "/v1/models/other")[0] == 404
        assert _post(port, "other", {"instances": rows})[0] == 404
        assert srv.apply_calls == 2


def test_bad_requests_are_400(export_dir):
    good = _rows(1, seed=2)[0]
    ragged = dict(good, input_ids=good["input_ids"][:-1])
    with serving.ModelServer(export_dir, name="qa", port=0, device="cpu",
                             batch_window_ms=5) as srv:
        port = srv.address[1]
        cases = {
            "ragged": {"instances": [good, ragged]},
            "non-numeric": {"instances": [dict(good, input_ids=["a"] * S)]},
            "empty": {"instances": []},
            "no inputs": {"rows": [good]},
            "0-d": {"inputs": {"input_ids": 3}},
            "batch-size mismatch": {"inputs": {
                "input_ids": [good["input_ids"]] * 2,
                "attention_mask": [good["attention_mask"]]}},
            "keys differ": {"instances": [good, {"input_ids": [1]}]},
        }
        for name, body in cases.items():
            status, resp = _post(port, "qa", body)
            assert status == 400, (name, status, resp)
        assert _post(port, "qa", b"{not json")[0] == 400
        assert srv.apply_calls == 0
        # the server still answers after the refusals
        assert _post(port, "qa", {"instances": [good]})[0] == 200


def test_window_coalesces_requests_without_changing_rows(export_dir, model):
    """12 concurrent requests of 1-3 rows through a 200 ms window: fewer
    apply calls than requests, and every row as the model gives it
    alone."""
    reqs = [_rows(1 + i % 3, seed=10 + i) for i in range(12)]
    out = [None] * len(reqs)
    errors = []
    with serving.ModelServer(export_dir, name="qa", port=0, device="cpu",
                             batch_window_ms=200) as srv:
        port = srv.address[1]
        barrier = threading.Barrier(len(reqs))

        def client(i):
            try:
                barrier.wait(timeout=60)
                out[i] = _post(port, "qa", {"instances": reqs[i]})
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        calls = srv.apply_calls
    assert not errors
    assert 1 <= calls < len(reqs)
    for rows, (status, body) in zip(reqs, out):
        assert status == 200
        start, end = _want(model, rows)
        got = body["predictions"]
        assert _rel([p["start_logits"] for p in got], start) <= GROUP_RTOL
        assert _rel([p["end_logits"] for p in got], end) <= GROUP_RTOL


def _batcher_run(batcher, batches, timeout=60):
    out = [None] * len(batches)
    errors = []
    barrier = threading.Barrier(len(batches))

    def submit(i):
        try:
            barrier.wait(timeout=timeout)
            out[i] = batcher.submit(batches[i])
        except Exception as e:  # noqa: BLE001 - returned
            errors.append(e)

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    return out, errors


def test_batcher_keeps_signatures_apart_and_respects_max_batch():
    groups = []
    lock = threading.Lock()

    def apply(batch):
        with lock:
            groups.append({k: v.shape for k, v in batch.items()})
        return {"y": batch["x"] * 2.0}

    b = serving._Batcher(apply, window_ms=300, max_batch=4)
    try:
        batches = ([{"x": np.full((1, 3), i, np.float32)} for i in range(6)]
                   + [{"x": np.full((1, 5), 9, np.float32)}
                      for _ in range(2)])
        out, errors = _batcher_run(b, batches)
        assert not errors
        for batch, got in zip(batches, out):
            assert np.array_equal(got["y"], batch["x"] * 2.0)
        rows = {3: 0, 5: 0}
        for g in groups:
            assert g["x"][0] <= 4  # max_batch
            rows[g["x"][1]] += g["x"][0]
        assert rows == {3: 6, 5: 2}  # each signature in its own groups
        assert len(groups) < len(batches)
        # a single request larger than max_batch runs alone, whole
        del groups[:]
        big = {"x": np.arange(18, dtype=np.float32).reshape(6, 3)}
        assert np.array_equal(b.submit(big)["y"], big["x"] * 2.0)
        assert groups == [{"x": (6, 3)}]
    finally:
        b.stop()


def test_batcher_stop_fails_stragglers_and_new_requests():
    """A group in flight finishes; a request that raced ``stop`` past its
    sentinel fails at once (not after its submit timeout); later submits
    are refused."""
    import time

    started = threading.Event()
    release = threading.Event()

    def apply(batch):
        started.set()
        release.wait(30)
        return batch["x"]

    b = serving._Batcher(apply, window_ms=0)
    result = []
    first = threading.Thread(target=lambda: result.append(
        b.submit({"x": np.ones((1, 2))})))
    first.start()
    assert started.wait(30)
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    deadline = time.monotonic() + 30
    while b._q.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)  # stop()'s sentinel is queued
    straggler = {"batch": {"x": np.ones((1, 2))}, "done": threading.Event()}
    b._q.put(straggler)
    release.set()
    for t in (first, stopper):
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(result) == 1 and np.array_equal(result[0], np.ones((1, 2)))
    assert straggler["done"].is_set()
    assert isinstance(straggler["error"], RuntimeError)
    with pytest.raises(RuntimeError, match="stopping"):
        b.submit({"x": np.ones((1, 2))})


def test_both_packages_serve_the_same_json(tmp_path, export_dir,
                                           flax_params):
    """The same converted bert_tiny behind the JAX package's server and
    the port's: the same prediction keys and logits."""
    cfg = jbert.bert_tiny()
    cfg.dtype = jax.numpy.float32
    jm = jbert.BertForQuestionAnswering(cfg)

    def japply(variables, batch):
        start, end = jm.apply(variables, *[batch[k] for k in KEYS])
        return {"start_logits": start, "end_logits": end}

    jdir = str(tmp_path / "jax_export")
    jexport.save_model(jdir, japply, {"params": flax_params},
                       signature={"inputs": list(KEYS)})
    rows = _rows(4, seed=3)
    ref = jserving.ModelServer(jdir, name="qa", port=0)
    try:
        want = ref.predict({"instances": rows})
        want_cols = ref.predict({"inputs": {k: [r[k] for r in rows]
                                            for k in KEYS}})
    finally:
        ref.stop()
    ours = serving.ModelServer(export_dir, name="qa", port=0, device="cpu")
    try:
        got = ours.predict({"instances": rows})
        got_cols = ours.predict({"inputs": {k: [r[k] for r in rows]
                                            for k in KEYS}})
    finally:
        ours.stop()
    assert list(got) == list(want) == ["predictions"]
    assert [sorted(p) for p in got["predictions"]] == \
        [sorted(p) for p in want["predictions"]]
    for key in ("start_logits", "end_logits"):
        w = np.array([p[key] for p in want["predictions"]])
        g = np.array([p[key] for p in got["predictions"]])
        assert _rel(g, w) <= SERVE_RTOL
        assert _rel(got_cols["outputs"][key],
                    np.array(want_cols["outputs"][key])) <= SERVE_RTOL

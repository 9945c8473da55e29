"""Prefill/decode disaggregation on the port — the fleet-free half of
the reference's ``tests/test_disagg.py``.

- WIRE: ``kvship.pack``/``unpack`` round trip; the port's ``unpack``
  reads the reference's ``pack`` bytes (and the reverse) identically;
  malformed frames are refused.
- ENGINE: prefill on engine A, ship the packed chain, splice into
  engine B, decode: the tokens equal A's at float and int8 KV, a
  duplicate delivery is a no-op, and a shipment the JAX engine packed
  from the same converted weights splices into the port's engine and
  decodes to the JAX engine's tokens. int8 wire bytes stay under a
  third of the float pool's for the same chain.
- HTTP: ``:prefill`` ships to a peer's ``/kv/splice`` (socket and the
  co-hosted shm ring), bytes accounted on both ends; ``/admin/
  ship_fence`` floors refuse stale epochs with reason "fenced"; a
  port-``chaos`` partition that drops the splice response leaves
  ``shipped: false`` with no bytes accounted, and the decode server
  still serves the right tokens.

Head dim 16 (hidden 64, 4 heads), as the reference's file has it: at
head dim 8 the per-head scales alone break the one-third ratio.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorflowonspark_tpu import kvship as jkvship
from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import (chaos, convert, frames, kvship,
                                         serving)
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

V, H, NH, L, T = 64, 64, 4, 2, 96
BLOCK = 16


@pytest.fixture(scope="module")
def lm():
    train = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    params = train.init(jax.random.PRNGKey(7),
                        jnp.zeros((2, T), jnp.int32))["params"]
    dec = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T,
                decode=True)
    return dec, params


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.disarm()


def _port(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    m.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return m


def _prompt(n, seed=0):
    return [int(t) for t in np.random.RandomState(seed).randint(1, V, n)]


def _engine(params, kv_dtype=None, **kw):
    return serving.DecodeEngine(_port(params), slots=2,
                                kv_block_size=BLOCK, kv_blocks=64,
                                kv_dtype=kv_dtype, device="cpu", **kw)


def _wire(buffers):
    return b"".join(bytes(b) for b in buffers)


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _post_raw(url, buffers, timeout=60):
    req = urllib.request.Request(
        url, data=_wire(buffers),
        headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _kv_counts(eng):
    return eng.kv_counters.snapshot()["counts"]


# -- wire format ------------------------------------------------------------

def test_pack_unpack_roundtrip_and_reference_interop():
    rows = [("k0", np.arange(24, dtype=np.int8).reshape(2, 3, 4)),
            ("v0", np.ones((2, 5), np.float32))]
    meta = {"tokens": [1, 2, 3], "block_size": 16, "kv_dtype": "int8",
            "origins": ["prompt", "prompt"], "src_replica": "r-a",
            "src_epoch": 7}
    buffers = kvship.pack(meta, rows)
    wire = _wire(buffers)
    # byte-identical to the reference's packing of the same shipment
    assert wire == _wire(jkvship.pack(meta, rows))
    assert frames.frame_bytes(buffers) == len(wire)
    for unpack in (kvship.unpack, jkvship.unpack):
        meta2, rows2 = unpack(wire)
        assert meta2["v"] == kvship.WIRE_VERSION == jkvship.WIRE_VERSION
        assert meta2["n_blocks"] == 2
        for key in meta:
            assert meta2[key] == meta[key]
        for (n1, a1), (n2, a2) in zip(rows, rows2):
            assert n1 == n2
            got = np.asarray(a2)
            assert got.dtype == a1.dtype
            np.testing.assert_array_equal(got, a1)
    assert kvship.split_addr("127.0.0.1:85") == ("127.0.0.1", 85)
    assert kvship.split_addr(("h", "9")) == ("h", 9)


def test_unpack_refuses_malformed():
    with pytest.raises(ValueError):
        kvship.unpack(b"not a shipment")
    wire = _wire(frames.encode_multi([{"v": 99}]))
    with pytest.raises(ValueError):
        kvship.unpack(wire)


# -- engine splice parity -----------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
def test_splice_parity(lm, kv_dtype):
    """Prefill on A, ship, splice into B, decode on B: B's tokens are
    A's, B's prefix hits are the shipped blocks, and a second delivery
    of the same shipment splices nothing."""
    _, params = lm
    prompt = _prompt(64, seed=3)
    with _engine(params, kv_dtype) as a:
        ref = a.submit(prompt, 6).result(300)
        buffers, meta = a.export_prefix(prompt, src_epoch=1)
        assert len(meta["origins"]) == len(prompt) // BLOCK == 4
        assert meta["kv_dtype"] == (kv_dtype or "float32")
    meta2, rows = kvship.unpack(_wire(buffers))
    with _engine(params, kv_dtype) as b:
        result = b.import_prefix(meta2, rows)
        assert result == {"spliced_blocks": 4, "skipped_blocks": 0,
                          "bytes": result["bytes"]}
        assert b.submit(prompt, 6).result(300) == ref
        # the last block is recomputed: a prefill needs the logits at
        # the prompt's last position, so a hit leaves >= 1 token
        counts = b.counters.snapshot()["counts"]
        assert counts["prefix_hit_blocks"] == (len(prompt) - 1) // BLOCK
        kv = _kv_counts(b)
        assert kv["spliced_blocks"] == 4
        assert kv["spliced_bytes"] == result["bytes"] > 0
        again = b.import_prefix(meta2, rows)
        assert again == {"spliced_blocks": 0, "skipped_blocks": 4,
                         "bytes": 0}
        assert b.submit(prompt, 6).result(300) == ref
        assert b._pool.live_refs() == {}


def test_splice_rejections_name_their_reason(lm):
    _, params = lm
    prompt = _prompt(40, seed=4)
    with _engine(params) as a:
        a.submit(prompt, 1).result(300)
        buffers, _ = a.export_prefix(prompt)
        assert a.export_prefix(prompt[:10]) is None  # under one block
    meta, rows = kvship.unpack(_wire(buffers))
    with _engine(params, "int8") as b:
        with pytest.raises(serving.SpliceRejected) as e:
            b.import_prefix(meta, rows)
        assert e.value.reason == "kv_dtype"
    with serving.DecodeEngine(_port(params), slots=2, kv_block_size=8,
                              device="cpu") as b:
        with pytest.raises(serving.SpliceRejected) as e:
            b.import_prefix(meta, rows)
        assert e.value.reason == "block_size"
    with serving.DecodeEngine(_port(params), slots=2, kv_block_size=0,
                              device="cpu") as b:
        assert b.export_prefix(prompt) is None
        with pytest.raises(serving.SpliceRejected) as e:
            b.import_prefix(meta, rows)
        assert e.value.reason == "unpaged"
    with _engine(params) as b:
        with pytest.raises(serving.SpliceRejected) as e:
            b.import_prefix(meta, [(k, r[:1]) for k, r in rows])
        assert e.value.reason == "malformed"
        with pytest.raises(serving.SpliceRejected) as e:
            b.import_prefix(meta, rows[1:])
        assert e.value.reason == "malformed"
        assert b._pool.live_refs() == {} and b._pool.allocatable() == 64


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
def test_reference_shipment_splices_into_the_port(lm, kv_dtype):
    """A shipment the JAX engine packed splices into the port's engine
    (same converted weights) and decodes to the JAX engine's tokens;
    the port's own export of the prompt carries the same header and
    rows within float noise (int8 codes within one step)."""
    dec, params = lm
    prompt = _prompt(48, seed=5)
    with jserving.DecodeEngine(dec, params, slots=2, kv_block_size=BLOCK,
                               kv_blocks=64, kv_dtype=kv_dtype) as j:
        want = j.submit(prompt, 6).result(300)
        jbuf, _ = j.export_prefix(prompt)
    jmeta, jrows = kvship.unpack(_wire(jbuf))
    with _engine(params, kv_dtype) as b:
        assert b.import_prefix(jmeta, jrows)["spliced_blocks"] == 3
        assert b.submit(prompt, 6).result(300) == want
        buffers, meta = b.export_prefix(prompt)
    for key in ("tokens", "block_size", "kv_dtype", "origins"):
        assert meta[key] == jmeta[key]
    pmeta, prows = kvship.unpack(_wire(buffers))
    assert [k for k, _ in prows] == [k for k, _ in jrows]
    for (key, got), (_, ref) in zip(prows, jrows):
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        tol = 1 if got.dtype == np.int8 else 1e-5
        assert np.abs(got.astype(np.float64) - ref).max() <= tol, key


def test_int8_wire_bytes_under_third_of_fp_pool(lm):
    _, params = lm
    prompt = _prompt(64, seed=5)
    wire = {}
    for kv_dtype in ("int8", None):
        with _engine(params, kv_dtype) as eng:
            eng.submit(prompt, 1).result(300)
            buffers, meta = eng.export_prefix(prompt)
            wire[kv_dtype or "fp"] = frames.frame_bytes(buffers)
            assert len(meta["origins"]) == 4
    assert wire["int8"] <= wire["fp"] / 3.0
    head_dim = H // NH
    payload = 4 * BLOCK * 2 * L * NH * (head_dim + 4)
    assert abs(wire["int8"] - payload) < 2048


# -- HTTP ------------------------------------------------------------------

def _mk_server(params, replica_id, kv_dtype="int8", tier="mixed"):
    eng = _engine(params, kv_dtype, replica_id=replica_id, tier=tier)
    server = serving.ModelServer(None, engine=eng, name="m", port=0)
    host, port = server.start()
    return eng, server, "{}:{}".format(host, port)


def _stop(*pairs):
    for srv, eng in pairs:
        srv.stop()
        eng.stop()


def test_prefill_endpoint_ships_physical_bytes(lm):
    _, params = lm
    prompt = _prompt(48, seed=11)
    eng_p, srv_p, addr_p = _mk_server(params, "rep-p", tier="prefill")
    eng_d, srv_d, addr_d = _mk_server(params, "rep-d", tier="decode")
    try:
        status, out = _post(
            "http://{}/v1/models/m:prefill".format(addr_p),
            {"prompt": prompt, "src_epoch": 3,
             "ship": {"addr": addr_d, "replica_id": "rep-d"}})
        assert status == 200
        assert out["prefilled"] and out["shipped"], out
        assert out["blocks"] == 3
        assert out["transport"] in ("shm", "socket")
        logical_fp = 3 * BLOCK * 2 * L * NH * (H // NH) * 4
        assert 0 < out["bytes"] <= logical_fp / 3.0
        assert _kv_counts(eng_p)["ship_bytes"] == out["bytes"]
        assert _kv_counts(eng_p)["ship_blocks"] == 3
        assert _kv_counts(eng_d)["spliced_blocks"] == 3
        assert out["splice"]["spliced_blocks"] == 3
        assert eng_p.load_stats()["tier"] == "prefill"
        assert eng_d.load_stats()["kv_spliced_blocks"] == 3
        ref = eng_p.submit(prompt, 5).result(300)
        assert eng_d.submit(prompt, 5).result(300) == ref
        assert eng_d.counters.snapshot()["counts"]["prefix_hit_blocks"] \
            == (len(prompt) - 1) // BLOCK
        # the body answers 400 on a nested prompt, the route 404 elsewhere
        with pytest.raises(urllib.error.HTTPError) as e:
            _post("http://{}/v1/models/m:prefill".format(addr_p),
                  {"prompt": [prompt]})
        assert e.value.code == 400
    finally:
        _stop((srv_p, eng_p), (srv_d, eng_d))


@pytest.mark.parametrize("via", ["socket", "shm"])
def test_ship_transports_deliver_the_same_splice(lm, via):
    """Both transports of ``kvship.ship`` land the shipment: the socket
    body, and the co-hosted shm ring with an empty-body notify."""
    from tensorflowonspark_tpu_torch import shm

    if via == "shm" and not shm.available():
        pytest.skip("the native shm ring does not build on this host")
    _, params = lm
    prompt = _prompt(40, seed=17)
    with _engine(params) as a:
        a.submit(prompt, 1).result(300)
        buffers, _ = a.export_prefix(prompt)
    eng_d, srv_d, addr_d = _mk_server(params, "rep-d", kv_dtype=None)
    try:
        status, body, transport = kvship.ship(addr_d, buffers, src="a",
                                              dst="rep-d", via=via)
        assert (status, transport) == (200, via)
        assert json.loads(body)["spliced_blocks"] == 2
    finally:
        _stop((srv_d, eng_d))
        kvship.close_rings()


def test_ship_fence_floor_rejects_stale_epoch(lm):
    _, params = lm
    prompt = _prompt(32, seed=13)
    eng_p, srv_p, _ = _mk_server(params, "rep-p")
    eng_d, srv_d, addr_d = _mk_server(params, "rep-d")
    try:
        eng_p.submit(prompt, 1).result(300)
        buffers, _ = eng_p.export_prefix(prompt, src_epoch=4)
        status, out = _post("http://{}/admin/ship_fence".format(addr_d),
                            {"replica_id": "rep-p", "min_epoch": 4})
        assert status == 200 and out["min_epoch"] == 4
        _post("http://{}/admin/ship_fence".format(addr_d),
              {"replica_id": "rep-p", "min_epoch": 2})
        _, out = _post("http://{}/admin/ship_fence".format(addr_d),
                       {"replica_id": "rep-p", "min_epoch": 0})
        assert out["min_epoch"] == 4  # floors never lower
        status, body = _post_raw("http://{}/kv/splice".format(addr_d),
                                 buffers)
        assert status == 409 and body["reason"] == "fenced"
        assert _kv_counts(eng_d).get("spliced_blocks", 0) == 0
        assert eng_d.splice_failures() == {"fenced": 1}
        status, body = _post_raw("http://{}/kv/splice".format(addr_d),
                                 [b"garbage"])
        assert status == 400
        assert eng_d.splice_failures() == {"fenced": 1, "malformed": 1}
        buffers2, _ = eng_p.export_prefix(prompt, src_epoch=5)
        status, body = _post_raw("http://{}/kv/splice".format(addr_d),
                                 buffers2)
        assert status == 200 and body["spliced_blocks"] == 2
    finally:
        _stop((srv_p, eng_p), (srv_d, eng_d))


def test_partition_mid_shipment_falls_back_cold(lm):
    """The partition's opening exchange loses the splice RESPONSE (the
    shipment landed, unconfirmed): ``:prefill`` answers ``shipped:
    false`` with no bytes accounted, and the decode server serves the
    right tokens (its resident-chain dedupe makes the unconfirmed
    splice harmless). After the heal the next shipment is confirmed."""
    _, params = lm
    prompt = _prompt(20, seed=23)
    prompt2 = _prompt(20, seed=29)
    eng_p, srv_p, addr_p = _mk_server(params, "rep-p", kv_dtype=None)
    eng_d, srv_d, addr_d = _mk_server(params, "rep-d", kv_dtype=None)
    try:
        ship = {"addr": addr_d, "replica_id": "rep-d"}
        chaos.arm("net_partition=rep-p:rep-d,for=0.2")
        status, out = _post("http://{}/v1/models/m:prefill".format(addr_p),
                            {"prompt": prompt, "ship": ship})
        assert status == 200
        assert out["shipped"] is False and "reason" in out
        assert _kv_counts(eng_p).get("ship_bytes", 0) == 0
        status, out = _post(
            "http://{}/v1/models/m:generate".format(addr_d),
            {"prompt": prompt, "max_new_tokens": 5})
        assert out["tokens"] == eng_p.submit(prompt, 5).result(300)
        chaos.disarm()
        status, out = _post("http://{}/v1/models/m:prefill".format(addr_p),
                            {"prompt": prompt2, "ship": ship})
        assert out["shipped"] is True
        assert _kv_counts(eng_p)["ship_bytes"] == out["bytes"] > 0
    finally:
        _stop((srv_p, eng_p), (srv_d, eng_d))
        kvship.close_rings()

"""The port's control-state journal (``controlstate.ControlJournal``) and
the reservation server's durable epochs, held against the JAX package.

- The reference's own cases of ``tests/test_controlstate.py`` (journal
  mechanics, the journal-seeded server, the seeded crash interleavings
  and the real SIGKILL mid-mint loop) run on both packages.
- The file format is the reference's byte for byte: a journal written
  by either package reads back identically in the other, and the same
  call sequence writes identical bytes (compaction included).
- The reservation server's serving view (``serving_snapshot``, the
  ``/stats`` ``serving`` key) and its control gauges have the
  reference's shape.
"""

import json
import os
import urllib.request

import pytest

import test_torch_qos
from tensorflowonspark_tpu import controlstate as jcontrolstate
from tensorflowonspark_tpu import reservation as jreservation
from tensorflowonspark_tpu_torch import controlstate, reservation

_KILL_CHILD = r"""
import sys, time
from tensorflowonspark_tpu_torch import reservation
srv = reservation.Server(0, journal=sys.argv[1])
out = open(sys.argv[2], "a", buffering=1)
i = 0
while True:
    e = srv.mint_epoch("id-%d" % (i % 3))
    # the epoch is "returned to a caller" the moment it is written out
    out.write("id-%d %d\n" % (i % 3, e))
    i += 1
    time.sleep(0.002)
"""

REF, PORT = test_torch_qos.reference_cases(
    "test_controlstate.py", controlstate=controlstate,
    reservation=reservation, ControlJournal=controlstate.ControlJournal,
    JournalCorrupt=controlstate.JournalCorrupt)
PORT["_KILL_CHILD"] = _KILL_CHILD

CASES = (
    "test_journal_roundtrip_floors_and_meta",
    "test_journal_floor_is_max_not_last",
    "test_torn_final_line_tolerated",
    "test_mid_file_corruption_refuses_loudly",
    "test_compaction_preserves_floors",
    "test_journal_close_idempotent",
    "test_server_seeds_floors_and_mints_strictly_above",
    "test_crash_between_fsync_and_reply_floor_runs_ahead",
    "test_recovering_grace_semantics",
    "test_server_without_journal_unchanged",
    "test_property_floor_covers_every_returned_epoch",
)


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    fn = getattr(REF, case)
    args = {"tmp_path": tmp_path / "ref", "monkeypatch": monkeypatch}
    (tmp_path / "ref").mkdir()
    fn(**{k: args[k] for k in fn.__code__.co_varnames[
        :fn.__code__.co_argcount]})
    (tmp_path / "port").mkdir()
    args["tmp_path"] = tmp_path / "port"
    fn = PORT[case]
    fn(**{k: args[k] for k in fn.__code__.co_varnames[
        :fn.__code__.co_argcount]})


@pytest.mark.parametrize("delay", [0.05, 0.15])
def test_real_sigkill_mid_mint_loop_on_the_port(tmp_path, delay):
    """The reference's out-of-process kill point, the child minting
    through the port's reservation server and journal."""
    PORT["test_real_sigkill_mid_mint_loop_floor_covers_output"](
        tmp_path, delay)


def _write_sequence(module, path, compact_every=4096):
    j = module.ControlJournal(path, compact_every=compact_every)
    j.record_epoch("replica-0", 1)
    j.record_epoch("replica-1", 3)
    j.record_epoch("replica-0", 2)
    j.record_control(1)
    j.record_lease_meta("replica-1", {"addr": ["127.0.0.1", 9],
                                      "model": "lm"})
    j.record_epoch(7, 4)
    j.record_control(5)
    j.close()


def _read_back(module, path):
    j = module.ControlJournal(path)
    try:
        return (j.epoch_floors(), j.control_floor(), j.lease_meta())
    finally:
        j.close()


@pytest.mark.parametrize("compact_every", [4096, 3])
def test_journal_bytes_equal_and_cross_readable(tmp_path, compact_every):
    """The same call sequence writes the same bytes in both packages (a
    ``compact_every`` of 3 compacts twice on the way), and each package
    reads the other's journal back to the same floors and metadata."""
    ref_path = str(tmp_path / "ref.journal")
    port_path = str(tmp_path / "port.journal")
    _write_sequence(jcontrolstate, ref_path, compact_every)
    _write_sequence(controlstate, port_path, compact_every)
    assert open(ref_path, "rb").read() == open(port_path, "rb").read()
    want = _read_back(jcontrolstate, ref_path)
    assert want[0] == {"replica-0": 2, "replica-1": 3, 7: 4}
    assert want[1] == 5
    assert _read_back(controlstate, ref_path) == want
    assert _read_back(jcontrolstate, port_path) == want


def test_server_seeded_from_the_other_packages_journal(tmp_path):
    """A reservation server of either package seeded from a journal the
    other package's server wrote mints strictly above its floors."""
    for writer, reader in ((jreservation, reservation),
                           (reservation, jreservation)):
        path = str(tmp_path / (writer.__name__ + ".journal"))
        srv = writer.Server(0, journal=path)
        assert [srv.mint_epoch("r") for _ in range(3)] == [1, 2, 3]
        assert srv.mint_control_epoch() == 1
        srv.stop()
        seeded = reader.Server(0, journal=path)
        assert seeded.recovering()
        assert seeded.mint_epoch("r") == 4
        assert seeded.mint_control_epoch() == 2
        assert not seeded.recovering()
        seeded.stop()


def _serving_view(module):
    srv = module.Server(0)
    addr = srv.start(host="127.0.0.1")
    client = module.Client(addr)
    try:
        client.beat(0, {"state": "running", "train_step": 3})
        epoch = client.lease("replica-0")
        client.beat("replica-0", {
            "role": "serving", "replica_id": "replica-0",
            "addr": ["127.0.0.1", 1234], "model": "lm",
            "host": {"executor": 1, "pid": 42},
            "serving": {"queue_depth": 2, "slot_occupancy": 1,
                        "queue_wait_ewma_s": 0.05, "alive": True,
                        "draining": False},
            "metrics": {"counters": {}}}, epoch=epoch)
        srv.mint_control_epoch()
        snap = srv.serving_snapshot()
        with urllib.request.urlopen(
                "http://%s:%d/stats" % tuple(srv.stats_addr),
                timeout=30) as r:
            stats = json.loads(r.read())
        gauges = srv.cluster_gauges()
    finally:
        client.close()
        srv.stop()
    for view in snap.values():
        view["age"] = 0.0
    for view in stats["serving"].values():
        view["age"] = 0.0
    return snap, stats["serving"], gauges


def test_serving_snapshot_and_stats_view_have_the_references_shape():
    snap, stats, gauges = _serving_view(reservation)
    jsnap, jstats, jgauges = _serving_view(jreservation)
    assert snap == jsnap
    assert stats == jstats
    assert gauges == jgauges == {"tfos_control_epoch": 1}
    assert set(snap) == {"replica-0"}
    assert snap["replica-0"]["epoch"] == 1
    assert snap["replica-0"]["host"] == {"executor": 1, "pid": 42}
    assert "metrics" not in stats["replica-0"]


def test_drop_lease_keeps_the_epoch():
    """``drop_lease`` deregisters a retired replica's lease but keeps its
    epoch: a zombie beat at the old epoch is fenced after a fresh mint."""
    srv = reservation.Server(0)
    addr = srv.start(host="127.0.0.1")
    client = reservation.Client(addr)
    try:
        epoch = client.lease("replica-3")
        client.beat("replica-3", {"role": "serving"}, epoch=epoch)
        assert "replica-3" in srv.serving_snapshot()
        assert srv.mint_epoch("replica-3") == epoch + 1
        assert srv.drop_lease("replica-3")
        assert not srv.drop_lease("replica-3")
        assert "replica-3" not in srv.serving_snapshot()
        with pytest.raises(reservation.Fenced):
            client.beat("replica-3", {"role": "serving"}, epoch=epoch)
        assert srv.lease_epoch("replica-3") == epoch + 1
    finally:
        client.close()
        srv.stop()


def test_journal_path_is_accepted_and_closed_by_stop(tmp_path):
    path = str(tmp_path / "j")
    srv = reservation.Server(0, journal=path)
    assert isinstance(srv.journal, controlstate.ControlJournal)
    srv.start(host="127.0.0.1")
    srv.mint_epoch("x")
    srv.stop()
    srv.journal.close()  # idempotent after stop()
    assert os.path.getsize(path) > 0

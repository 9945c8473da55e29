"""The concurrency lint over the port's threads.

The JAX package's analyzer (``tensorflowonspark_tpu/analysis``,
stdlib ``ast`` only; run as ``racecheck.run(paths, baseline)``) scans
``tensorflowonspark_tpu_torch/`` against the port's own baseline,
``tensorflowonspark_tpu_torch/racecheck_baseline.json``, where each
benign finding carries a written reason. A finding that is not in the
baseline fails; so does a baseline entry without a reason. The
streaming loop (``engine/streaming.py``) and the Spark adapter's job
thread (``engine/spark_adapter.py``, annotated ``# tfos:
unjoined(...)``) are covered like every other thread of the port.
"""

import io
import json
import os

from tensorflowonspark_tpu.analysis import racecheck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tensorflowonspark_tpu_torch")
BASELINE = os.path.join(PORT, "racecheck_baseline.json")


def _run(paths, baseline):
    out, err = io.StringIO(), io.StringIO()
    rc = racecheck.run(paths, baseline, out=out, err=err)
    return rc, out.getvalue() + err.getvalue()


def test_port_is_clean_against_its_baseline():
    rc, text = _run([PORT], BASELINE)
    assert rc == 0, text
    assert "0 new" in text and "4 baselined" in text, text


def test_every_baseline_entry_has_a_reason_and_still_matches():
    with open(BASELINE) as f:
        entries = json.load(f)["entries"]
    assert len(entries) == 4
    assert all(len(e["reason"].strip()) > 40 for e in entries)
    rc, text = _run([PORT], None)
    assert rc == 1
    for e in entries:
        assert e["key"] in text, e["key"]


def test_a_new_finding_fails(tmp_path):
    """A copy of the port's streaming loop with one more thread that is
    neither joined nor annotated is a new finding the baseline does not
    cover."""
    src = open(os.path.join(PORT, "engine", "streaming.py")).read()
    src += (
        "\n\ndef _leak():\n"
        "    t = threading.Thread(target=time.sleep, args=(1,),\n"
        "                         name='leak', daemon=True)\n"
        "    t.start()\n")
    bad = tmp_path / "tensorflowonspark_tpu_torch" / "engine"
    bad.mkdir(parents=True)
    (bad / "streaming.py").write_text(src)
    rc, text = _run([str(tmp_path / "tensorflowonspark_tpu_torch")],
                    BASELINE)
    assert rc == 1
    assert "thread-unjoined" in text, text

"""The port's example drivers end to end on the CPU — the port's
counterpart of ``tests/test_examples.py``.

Each test runs a driver of ``tensorflowonspark_tpu_torch/examples/`` in
a subprocess as a user would (``python -m
tensorflowonspark_tpu_torch.examples.<family>.<name> ... --device
cpu``), from a temporary directory, at the smallest size that still
trains (two nodes where the multi-node feed is the point: MNIST,
streaming, the pipeline; one elsewhere, which keeps the file's
processes few beside the rest of the suite), and asserts what the
reference's example tests assert: steps
taken, files written, predictions present, a resumed run continuing
from the saved step, accuracy and IoU above chance. Data is synthetic
from a seed (``mnist_data_setup --source synthetic`` where MNIST is
read). Each run has its own time limit, well inside the tier-1 budget.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "tensorflowonspark_tpu_torch.examples."
#: seconds one driver run may take here
RUN_TIMEOUT = 120


def _run(cwd, module, *args, ok=True, distributed=False):
    # two threads a process: the suite runs these beside other workers;
    # ``distributed`` lets a multi-node driver form its process group
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               TFOS_TPU_DISTRIBUTED="1" if distributed else "0",
               OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    out = subprocess.run(
        [sys.executable, "-m", PKG + module] + [str(a) for a in args],
        capture_output=True, text=True, timeout=RUN_TIMEOUT, env=env,
        cwd=str(cwd))
    if ok:
        assert out.returncode == 0, "{} failed:\n{}".format(
            module, out.stdout[-2000:] + out.stderr[-3000:])
    return out


def _stats(model_dir):
    with open(os.path.join(model_dir, "train_stats.json")) as f:
        return json.load(f)


def test_mnist_data_setup_and_spark(tmp_path):
    """CSV and TFRecord copies of a synthetic MNIST, then the CSV rows
    through ``cluster.run(InputMode.SPARK)`` into LeNet on two nodes."""
    data = tmp_path / "mnist"
    _run(tmp_path, "mnist.mnist_data_setup", "--output", data,
         "--num-train", 256, "--num-test", 32, "--format", "both",
         "--source", "synthetic", "--num-partitions", 2)
    assert sorted(os.listdir(data / "train")) == ["part-00000.csv",
                                                  "part-00001.csv"]
    lines = sum(len(open(data / "train" / p).read().splitlines())
                for p in os.listdir(data / "train"))
    assert lines == 256
    assert [p for p in os.listdir(data / "train-tfr")
            if p.startswith("part-")]
    model = tmp_path / "model"
    _run(tmp_path, "mnist.mnist_spark", "--cluster_size", 2,
         "--images", data / "train", "--model_dir", model,
         "--batch_size", 32, "--log_every", 5, "--device", "cpu")
    stats = _stats(model)
    assert stats["steps"] > 0 and stats["device"] == "cpu"


def test_mnist_tensorflow_mode(tmp_path):
    """``mnist_dist``'s InputMode.TENSORFLOW leg: the node reads its CSV
    shards itself."""
    data = tmp_path / "mnist"
    _run(tmp_path, "mnist.mnist_data_setup", "--output", data,
         "--num-train", 128, "--num-test", 16, "--format", "csv",
         "--source", "synthetic", "--num-partitions", 2)
    model = tmp_path / "model"
    _run(tmp_path, "mnist.mnist_spark", "--cluster_size", 1,
         "--input_mode", "tensorflow", "--images", data / "train",
         "--model_dir", model, "--batch_size", 32, "--device", "cpu")
    assert _stats(model)["steps"] == 4


def test_mnist_pipeline(tmp_path):
    """``TFEstimator.fit`` spins the cluster from a DataFrame, the chief
    exports, ``TFModel.transform`` scores the test rows from the export:
    well above chance on 10 classes."""
    out = _run(tmp_path, "mnist.mnist_pipeline", "--cluster_size", 2,
               "--images", tmp_path / "mnist", "--num_train", 512,
               "--epochs", 2, "--source", "synthetic",
               "--export_dir", tmp_path / "export", "--device", "cpu")
    line = [ln for ln in out.stdout.splitlines()
            if "test accuracy" in ln][-1]
    acc = float(line.split("test accuracy")[1].split()[0])
    assert acc > 0.5, line
    assert os.path.isfile(tmp_path / "export" / "meta.json")


def test_streaming_mnist(tmp_path):
    """Files landed in a spool directory (hidden, then renamed) stream
    through ``textFileStream`` into ``tfc.train(dstream)``;
    ``shutdown(ssc)`` stops the stream before ending the feed."""
    model = tmp_path / "model"
    _run(tmp_path, "streaming.streaming_mnist", "--cluster_size", 2,
         "--intervals", 2, "--interval_examples", 128,
         "--interval_secs", 1.5, "--source", "synthetic",
         "--spool_dir", tmp_path / "spool", "--model_dir", model,
         "--device", "cpu")
    assert _stats(model)["steps"] > 0
    spooled = os.listdir(tmp_path / "spool")
    assert len(spooled) == 2 and not [n for n in spooled
                                      if n.startswith(".")]


def test_bert_squad(tmp_path):
    """BERT QA through the cluster (tiny config, ``--dropout 0``: the flash
    route, here its plain versions); the chief records every step's
    loss."""
    model = tmp_path / "bert"
    _run(tmp_path, "bert.bert_squad_spark", "--cluster_size", 1,
         "--num_examples", 64, "--batch_size", 8, "--model_dir", model,
         "--dropout", 0, "--device", "cpu")
    stats = _stats(model)
    assert stats["steps"] > 0 and len(stats["losses"]) == stats["steps"]
    assert stats["config"]["dropout_rate"] == 0.0
    assert stats["startup_s"] > 0


def test_bert_squad_reference_dropout(tmp_path):
    """Without ``--dropout`` the example trains as the reference's does:
    the config's dropout 0.1 with a dropout stream per step (the einsum
    path)."""
    model = tmp_path / "bert"
    _run(tmp_path, "bert.bert_squad_spark", "--cluster_size", 1,
         "--num_examples", 32, "--batch_size", 8, "--model_dir", model,
         "--device", "cpu")
    stats = _stats(model)
    assert stats["steps"] == 4 and len(stats["losses"]) == 4
    assert stats["config"]["dropout_rate"] == 0.1
    assert all(l == l for l in stats["losses"])  # finite, not NaN


def test_cifar10_spark(tmp_path):
    model = tmp_path / "cifar"
    _run(tmp_path, "cifar10.cifar10_spark", "--cluster_size", 1,
         "--num_examples", 128, "--batch_size", 32, "--model_dir", model,
         "--device", "cpu")
    assert _stats(model)["steps"] > 0


def test_segmentation_spark(tmp_path):
    """U-Net through the SPARK feed: the held-out mean IoU beats the
    ~0.2 of guessing on 3 classes. One node, so the chief trains on
    every record (with two, how the partitions split between the nodes
    follows the timing, and so does the chief's IoU)."""
    model = tmp_path / "seg"
    _run(tmp_path, "segmentation.segmentation_spark", "--cluster_size", 1,
         "--num_examples", 192, "--batch_size", 16, "--image_size", 32,
         "--model_dir", model, "--device", "cpu")
    stats = _stats(model)
    assert stats["steps"] > 0
    assert stats["val_mean_iou"] > 0.3


def test_resnet_resume(tmp_path):
    """Submit the job twice with --ckpt_dir: the second run resumes from
    the first's final step."""
    model = tmp_path / "model"
    args = ["--cluster_size", 1, "--steps", 4, "--batch_size", 16,
            "--model_dir", model, "--ckpt_dir", tmp_path / "ckpt",
            "--ckpt_every", 2, "--device", "cpu"]
    _run(tmp_path, "resnet.resnet_spark", *args)
    first = _stats(model)
    assert first["start_step"] == 0 and first["end_step"] > 0
    _run(tmp_path, "resnet.resnet_spark", *args)
    second = _stats(model)
    assert second["start_step"] == first["end_step"]
    assert second["end_step"] > second["start_step"]


def test_resnet_tfrecords_and_profile_gate(tmp_path):
    """--make_data writes TFRecord shards the node reads with the port's
    codec; --profile raises naming the ROADMAP item it waits for."""
    model = tmp_path / "model"
    _run(tmp_path, "resnet.resnet_spark", "--cluster_size", 1,
         "--steps", 2, "--batch_size", 8, "--make_data", 64,
         "--data_dir", tmp_path / "tfr", "--model_dir", model,
         "--device", "cpu")
    stats = _stats(model)
    assert stats["input"] == "tfrecord" and stats["steps"] == 2
    assert stats["reader_records_per_sec"] > 0
    out = _run(tmp_path, "resnet.resnet_spark", "--profile",
               "--device", "cpu", ok=False)
    assert out.returncode != 0
    assert "ROADMAP Queue 1 item 10" in out.stderr


def test_inception_train_export_infer_roundtrip(tmp_path):
    """Cluster-fed Inception train → eval → export → cluster inference
    from the export."""
    model = tmp_path / "model"
    export_dir = tmp_path / "export"
    _run(tmp_path, "inception.inception_train", "--cluster_size", 1,
         "--num_examples", 64, "--batch_size", 16, "--image_size", 75,
         "--num_classes", 4, "--model_dir", model,
         "--export_dir", export_dir, "--device", "cpu")
    stats = _stats(model)
    assert stats["steps"] > 0
    assert 0.0 <= stats["val_accuracy"] <= 1.0, stats
    preds = tmp_path / "preds"
    _run(tmp_path, "inception.inception_inference", "--cluster_size", 1,
         "--num_images", 8, "--batch_size", 4, "--image_size", 75,
         "--num_classes", 4, "--export_dir", export_dir,
         "--output", preds, "--device", "cpu")
    rows = [ln for p in os.listdir(preds)
            for ln in open(preds / p).read().splitlines()]
    assert len(rows) == 8
    assert all(0 <= int(r.split("\t")[0]) < 4 for r in rows)


def test_inception_inference_random_init(tmp_path):
    """The inference driver with no export: seeded random weights,
    every image gets a prediction."""
    out = tmp_path / "preds"
    _run(tmp_path, "inception.inception_inference", "--cluster_size", 1,
         "--num_images", 12, "--batch_size", 4, "--image_size", 75,
         "--num_classes", 10, "--output", out, "--device", "cpu")
    assert os.listdir(out)


def _last_json(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_longcontext_learns_and_zigzag_matches_contiguous(tmp_path):
    """``train_long`` on a ring of 4 gloo ranks (``--seq_ranks 4``):
    the causal LM learns the periodic task in both layouts (the
    reference's test_longcontext_example_learns: last < 0.7 first), and
    the zigzag layout trains as the contiguous one does
    (test_longcontext_zigzag_matches_contiguous: first losses within
    1e-3, last within 5e-2 relative)."""
    runs = {}
    for layout in ("contiguous", "zigzag"):
        out = _run(tmp_path, "longcontext.train_long", "--seq_len", 256,
                   "--batch", 2, "--steps", 15, "--hidden", 32, "--layers",
                   1, "--period", 13, "--layout", layout, "--seq_ranks", 4,
                   "--device", "cpu")
        runs[layout] = stats = _last_json(out)
        assert stats["ranks"] == 4 and stats["layout"] == layout
        assert stats["losses"][-1] < 0.7 * stats["losses"][0], stats
        assert stats["tokens_per_s"] > 0 and stats["peak_bytes"] is None
    (f_c, l_c), (f_z, l_z) = ((runs[k]["losses"][0], runs[k]["losses"][-1])
                              for k in ("contiguous", "zigzag"))
    assert abs(f_c - f_z) < 1e-3, (f_c, f_z)
    assert abs(l_c - l_z) < 5e-2 * max(abs(l_c), 1e-3), (l_c, l_z)
    # a rank's flash calls a step on the CPU's plain route: none counted
    assert runs["zigzag"]["flash_launches_per_step"] == {
        "fwd": 0.0, "dq": 0.0, "dkv": 0.0}


def test_criteo_tfrecord_roundtrip(tmp_path):
    """``--save_tfrecords`` writes the ETL'd rows as dense TFRecord
    shards that read back equal to the ETL (the native batched decoder),
    and ``--tfrecord_dir`` trains from them on one node."""
    import numpy as np

    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.examples.criteo import criteo_spark

    tfr = tmp_path / "tfr"
    _run(tmp_path, "criteo.criteo_spark", "--save_tfrecords", tfr,
         "--num_examples", 256, "--cluster_size", 1)
    files = tfrecord.list_tfrecord_files(str(tfr))
    assert len(files) == 4
    schema = {"dense": ("float32", 13), "cat": ("int64", 26),
              "label": ("int64", 1)}
    got = [tfrecord.read_batch(f, schema) for f in files]
    want = [criteo_spark.etl(line) for line in
            criteo_spark.synthetic_criteo_lines(256)]
    np.testing.assert_array_equal(
        np.concatenate([g["dense"] for g in got]),
        np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(np.concatenate([g["cat"] for g in got]),
                                  np.stack([w[1] for w in want]))
    np.testing.assert_array_equal(
        np.concatenate([g["label"] for g in got])[:, 0],
        [w[2] for w in want])
    model = tmp_path / "model"
    _run(tmp_path, "criteo.criteo_spark", "--cluster_size", 1,
         "--tfrecord_dir", tfr, "--batch_size", 32, "--epochs", 1,
         "--model_dir", model, "--device", "cpu")
    stats = _stats(model)
    assert stats["input"] == "tfrecord" and stats["steps"] == 256 // 32
    assert stats["mesh"] == {"data": 1}


def test_criteo_tp_training_and_int8_predict(tmp_path):
    """``--tp 2 --cluster_size 2``: the queue-fed Wide & Deep trains on a
    {"data": 1, "model": 2} mesh of two gloo ranks, each holding half the
    table rows, and the int8 export answers ``:predict`` with one logit a
    row; ``--tp 2`` with a cluster that is not a multiple of it is
    refused (the port's contract difference)."""
    import numpy as np

    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.examples.criteo import criteo_spark

    model, export_dir = tmp_path / "model", tmp_path / "wd_int8"
    _run(tmp_path, "criteo.criteo_spark", "--cluster_size", 2, "--tp", 2,
         "--num_examples", 512, "--batch_size", 32, "--epochs", 1,
         "--model_dir", model, "--quantize_export", export_dir,
         "--device", "cpu", distributed=True)
    stats = _stats(model)
    assert stats["steps"] > 0 and stats["input"] == "spark-etl"
    assert stats["mesh"] == {"data": 1, "model": 2}
    assert stats["table_local_rows"] == stats["table_rows"] // 2
    rows = [criteo_spark.etl(line)
            for line in criteo_spark.synthetic_criteo_lines(3, seed=5)]
    with serving.ModelServer(str(export_dir), name="wd", port=0,
                             device="cpu") as srv:
        got = srv.predict({"instances": [
            {"dense": r[0].tolist(), "cat": r[1].tolist()} for r in rows]})
    logits = got["predictions"]  # one output: one float a row
    assert len(logits) == 3
    assert all(isinstance(x, float) and np.isfinite(x) for x in logits)
    out = _run(tmp_path, "criteo.criteo_spark", "--cluster_size", 3, "--tp",
               2, "--device", "cpu", ok=False)
    assert out.returncode != 0 and "multiple" in out.stderr


def test_lm_generate_serves_solo_identical(tmp_path):
    """``lm_generate``: the small LM learns the periodic task (the
    reference's test_generate_example asserts the continuation), the
    greedy continuation follows the period, and ``--serve`` through the
    paged engine gives solo ``generate``'s tokens for every request,
    tagged with ``--tenant`` / ``--priority`` (every served token is
    tallied to the tenant). The flags that wait for the fleet plane
    refuse, naming the ROADMAP item."""
    out = _run(tmp_path, "generate.lm_generate", "--steps", 80, "--serve",
               6, "--tenant", "a", "--priority", "high", "--device", "cpu")
    got = _last_json(out)
    assert got["loss"] < 0.2 * got["loss_first"], got
    assert got["generated"] == [(6 + i) % 4 for i in range(8)]
    serve = got["serve"]
    assert serve["requests"] == 6 and serve["solo_mismatches"] == 0
    assert serve["tenant_tokens"] == {"a": serve["tokens"]}, serve
    for flag in (["--fleet", 2], ["--executors", 2]):
        bad = _run(tmp_path, "generate.lm_generate", *flag, ok=False)
        assert bad.returncode != 0
        assert "ROADMAP Queue 1 item" in bad.stderr, bad.stderr

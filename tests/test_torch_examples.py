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


def _run(cwd, module, *args, ok=True):
    # two threads a process: the suite runs these beside other workers
    env = dict(os.environ, JAX_PLATFORMS="cpu", TFOS_TPU_DISTRIBUTED="0",
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

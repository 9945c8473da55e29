"""The port's ``export``, ``tfnode.export_saved_model`` and ``pipeline``
against the JAX package's surface.

- The params surface (``_COMMON_PARAMS``, every ``setXxx``/``getXxx``,
  ``merged_args``, ``Namespace``) matches the reference's attribute for
  attribute.
- ``export``: the round trip (a module-backed ``apply_fn`` through
  ``torch.func.functional_call`` on a ``meta`` skeleton), the per-process
  cache, the on-disk layout, a remote root refused, and a JAX export
  refused with a ``ValueError`` that names both formats; ``load_model``
  runs on the card unless the CPU is asked for.
- ``TFEstimator(...).setInputMode("tensorflow").fit(df)`` on a tiny
  ``DecoderLM``: the data goes to ``part-*`` TFRecords through
  ``dfutil``, the trainer reads them with the native codec, trains,
  checkpoints every 2 steps and exports from the chief;
  ``TFModel.transform`` then scores a held-out DataFrame from the export.
  Its ``next_token`` equals the trainer's own forward on the same rows,
  ``next_logit`` within 1e-5 relative (float32 on the CPU, the same
  weights, rows batched differently). The output schema is inferred.
- ``setInputMode("spark")``: ``fit`` feeds the DataFrame's
  ``input_mapping`` columns through the queue plane.
"""

import json
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import pipeline as jpipeline
from tensorflowonspark_tpu_torch import export, pipeline
from tensorflowonspark_tpu_torch.engine import Context

CFG = {"vocab": 64, "hidden": 32, "num_heads": 4, "num_layers": 2,
       "max_len": 128}
#: transform's logit against the trainer's own, relative (float32, CPU)
LOGIT_RTOL = 1e-5


def test_params_surface_matches_reference():
    assert pipeline._COMMON_PARAMS == jpipeline._COMMON_PARAMS
    for ours, theirs in ((pipeline.TFEstimator, jpipeline.TFEstimator),
                         (pipeline.TFModel, jpipeline.TFModel)):
        assert ours.PARAMS == theirs.PARAMS
    est = pipeline.TFEstimator(lambda a, c: None, {"lr": 0.1})
    jest = jpipeline.TFEstimator(lambda a, c: None, {"lr": 0.1})
    for name, default in pipeline._COMMON_PARAMS:
        camel = "".join(p.capitalize() for p in name.split("_"))
        assert getattr(est, "get" + camel)() == \
            getattr(jest, "get" + camel)() == default
        value = "v-" + name
        assert getattr(est, "set" + camel)(value) is est
        getattr(jest, "set" + camel)(value)
        assert getattr(est, "get" + camel)() == value
    assert vars(est.merged_args()) == vars(jest.merged_args())
    with pytest.raises(AttributeError):
        est.setNoSuchParam
    ns = pipeline.Namespace({"a": 1}, b=2)
    assert "a" in ns and sorted(ns) == ["a", "b"]
    assert ns == pipeline.Namespace(pipeline.Namespace(a=1, b=2))
    model = pipeline.TFModel({"export_dir": None})
    with pytest.raises(ValueError, match="export_dir"):
        model.transform(None)


def _make_apply_fn(cfg):
    """A module-backed apply_fn: the skeleton holds no weights of its
    own; functional_call runs it on the loaded variables."""

    def apply_fn(variables, batch):
        import torch
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        skeleton = DecoderLM(cfg["vocab"], hidden=cfg["hidden"],
                             num_heads=cfg["num_heads"],
                             num_layers=cfg["num_layers"],
                             max_len=cfg["max_len"], device="meta")
        with torch.no_grad():
            logits = torch.func.functional_call(skeleton, variables,
                                                (batch["x"],))
        last = logits[:, -1].float()
        return {"next_token": last.argmax(-1), "next_logit": last.max(-1)[0]}

    return apply_fn


def _model(seed):
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    m = DecoderLM(CFG["vocab"], hidden=CFG["hidden"],
                  num_heads=CFG["num_heads"], num_layers=CFG["num_layers"],
                  max_len=CFG["max_len"])
    return m.init_weights(torch.Generator().manual_seed(seed))


def test_export_roundtrip_cache_and_layout(tmp_path):
    model = _model(0)
    d = str(tmp_path / "export")
    sig = {"inputs": ["x"], "outputs": ["next_token", "next_logit"]}
    export.save_model(d, _make_apply_fn(CFG), model.state_dict(), sig)
    assert sorted(os.listdir(d)) == ["apply_fn.pkl", "meta.json",
                                     "variables.pt"]
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta == {"format": "tfos-torch-export-v1", "signature": sig}
    with pytest.raises(FileExistsError):
        export.save_model(d, _make_apply_fn(CFG), model.state_dict())
    fn, variables, got_sig = export.load_model(d, device="cpu")
    assert got_sig == sig
    assert all(torch.equal(variables[k], v)
               for k, v in model.state_dict().items())
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, CFG["vocab"], (3, 128)))
    out = fn(variables, {"x": x})
    with torch.no_grad():
        want = model(x)[:, -1]
    assert torch.equal(out["next_token"], want.argmax(-1))
    assert torch.allclose(out["next_logit"], want.max(-1)[0], rtol=1e-6)
    assert export.load_model(d, device="cpu")[0] is fn  # cached
    assert export.load_model(d, cache=False, device="cpu")[0] is not fn
    from tensorflowonspark_tpu_torch import fs
    with pytest.raises(fs.UnsupportedSchemeError):
        export.load_model("hdfs://nn/export", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.load_model(d)


def test_jax_export_refused_naming_both_formats(tmp_path):
    import jax.numpy as jnp

    from tensorflowonspark_tpu import export as jexport

    d = str(tmp_path / "jax-export")
    jexport.save_model(d, lambda v, b: {"y": b["x"] * v["w"]},
                       {"w": jnp.asarray(2.0)})
    with pytest.raises(ValueError) as err:
        export.load_model(d, device="cpu")
    assert "tfos-torch-export-v1" in str(err.value)
    assert "tfos-tpu-export-v1" in str(err.value)


def test_fit_tensorflow_mode_then_transform(tmp_path):
    """TFRecords -> fit (InputMode.TENSORFLOW, checkpoint, chief export)
    -> transform from the export, against the trainer's own forward."""
    from tensorflowonspark_tpu_torch import dfutil

    rng = np.random.RandomState(3)
    train_rows = [{"tokens": r} for r in rng.randint(
        0, CFG["vocab"], (12, CFG["max_len"] + 1)).astype(np.int64)]
    held = rng.randint(0, CFG["vocab"], (6, CFG["max_len"])).astype(np.int64)
    held_path = str(tmp_path / "held.npy")
    np.save(held_path, held)
    apply_fn = _make_apply_fn(CFG)

    def train_fn(args, ctx):
        import sys

        import numpy as np
        import torch
        from tensorflowonspark_tpu_torch import (checkpoint, tfnode,
                                                 tfrecord, training)
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        dev = ctx.initialize_torch("cpu")
        cfg = args.cfg
        width = cfg["max_len"] + 1
        rows = np.concatenate([
            tfrecord.read_batch(f, {"tokens": ("int64", width)})["tokens"]
            for f in tfrecord.list_tfrecord_files(args.tfrecord_dir)])
        bs = args.batch_size
        batches = [{"x": rows[i:i + bs, :-1], "y": rows[i:i + bs, 1:]}
                   for i in range(0, len(rows), bs)]
        model = DecoderLM(cfg["vocab"], hidden=cfg["hidden"],
                          num_heads=cfg["num_heads"],
                          num_layers=cfg["num_layers"],
                          max_len=cfg["max_len"])
        tr = training.Trainer(model, training.adamw(1e-3), device=dev)
        state = tr.init(torch.Generator().manual_seed(1))
        ckpt = checkpoint.Checkpointer(args.model_dir, max_to_keep=None)
        state, steps, _ = tr.train_loop(
            state, iter(batches), log_every=0,
            hooks=(checkpoint.hook(ckpt, every_steps=2),))
        if ctx.job_name == "chief":
            tfnode.export_saved_model(
                args.export_dir, args.apply_fn, model.state_dict(),
                {"inputs": ["x"], "outputs": ["next_token", "next_logit"]})
            with torch.no_grad():
                last = model(torch.from_numpy(np.load(args.held)))[:, -1]
            np.savez(args.out, next_token=last.argmax(-1).numpy(),
                     next_logit=last.max(-1)[0].numpy(), steps=steps,
                     ckpt_steps=np.asarray(ckpt.all_steps()),
                     native=tfrecord.codec_reads["native"],
                     foreign=np.asarray(sorted(
                         m for m in sys.modules
                         if m.split(".")[0] in ("jax", "flax", "optax",
                                                "orbax", "cloudpickle",
                                                "tensorflowonspark_tpu")
                         and sys.modules[m] is not None), dtype=object))

    sc = Context(num_executors=1, work_root=str(tmp_path / "engine"))
    try:
        df = sc.createDataFrame(train_rows, num_slices=3)
        records = str(tmp_path / "records")
        assert dfutil.saveAsTFRecords(df, records) == len(train_rows)
        out = str(tmp_path / "trainer.npz")
        est = (pipeline.TFEstimator(train_fn, {
            "cfg": CFG, "held": held_path, "out": out, "apply_fn": apply_fn})
            .setClusterSize(1).setInputMode("tensorflow")
            .setTfrecordDir(records).setModelDir(str(tmp_path / "ckpt"))
            .setExportDir(str(tmp_path / "export")).setBatchSize(4))
        fitted = est.fit(df)
        assert isinstance(fitted, pipeline.TFModel)
        assert fitted.getExportDir() == str(tmp_path / "export")
        got = np.load(out, allow_pickle=True)
        assert int(got["steps"]) == 3
        assert list(got["ckpt_steps"]) == [2]
        assert int(got["native"]) == 3  # one native read per part file
        assert list(got["foreign"]) == []

        model = pipeline.TFModel(vars(fitted.merged_args()), device="cpu")
        model.setInputMapping({"tokens": "x"}).setOutputMapping(
            {"next_token": "next_token", "next_logit": "next_logit"})
        model.setBatchSize(4)
        held_df = sc.createDataFrame([{"tokens": r} for r in held],
                                     num_slices=2)
        scored = model.transform(held_df)
        assert sorted(scored.schema) == [("next_logit", "float32"),
                                         ("next_token", "int64")]
        rows = scored.collect()
    finally:
        sc.stop()
    assert len(rows) == len(held)
    assert [r["next_token"] for r in rows] == list(got["next_token"])
    np.testing.assert_allclose([r["next_logit"] for r in rows],
                               got["next_logit"], rtol=LOGIT_RTOL, atol=0)


def test_fit_spark_mode_feeds_the_mapped_columns(tmp_path):
    def train_fn(args, ctx):
        import json

        feed = ctx.get_data_feed(train_mode=True)
        seen = []
        while not feed.should_stop():
            batch = feed.next_batch(args.batch_size)
            seen.extend(list(r) for r in batch)
        with open(args.out, "w") as f:
            json.dump(seen, f)

    sc = Context(num_executors=1, work_root=str(tmp_path / "engine"))
    out = str(tmp_path / "seen.json")
    try:
        df = sc.createDataFrame([{"a": i, "b": 10 * i, "c": "z"}
                                 for i in range(10)], num_slices=2)
        (pipeline.TFEstimator(train_fn, {"out": out})
         .setInputMapping({"b": "feat_b", "a": "feat_a"})
         .setBatchSize(3).setClusterSize(1).fit(df))
    finally:
        sc.stop()
    assert sorted(json.load(open(out))) == [[10 * i, i] for i in range(10)]

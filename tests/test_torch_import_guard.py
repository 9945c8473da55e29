"""The port stands alone: it imports nothing of JAX, flax, optax, orbax,
the JAX package or cloudpickle, and its kernel modules import (and
serve — plainly, tenant-tagged over HTTP with a ``/metrics`` scrape,
speculatively, from a spliced KV shipment and through a one-replica
fleet's router with its supervisor and autoscaler armed — train, run a
cluster, recover a supervised job from a killed trainer with the
profiler hooks armed,
fit, checkpoint, export and transform through the pipeline, run the model zoo and ``:predict``, stream
micro-batches into a cluster, run TFParallel jobs, bind the Spark
adapter and import every example driver on the CPU) without a CUDA
compiler — kernels build at their first launch on a card."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tensorflowonspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "tensorflowonspark_tpu", "cloudpickle")
#: the cluster and feed plane's modules (each the port's own copy)
PLANE = ("util", "marker", "fs", "frames", "shm", "manager", "tracing",
         "goodput", "chaos", "datafeed", "tfnode", "reservation", "node",
         "cluster", "engine/__init__", "engine/serializer", "engine/rdd",
         "engine/context", "engine/executor", "engine/dataframe",
         "tfrecord", "_tfrecord_native", "dfutil", "checkpoint", "export",
         "pipeline", "engine/streaming", "engine/spark_adapter",
         "parallel_runner", "kvship", "qos", "slo", "metrics_report",
         "controlstate", "supervisor", "autoscale",
         # its trainer functions ship by reference: executors import it
         "profile_recovery")
EXAMPLES = os.path.join(PORT, "examples")
#: the parallel package's modules
PARALLEL = ("parallel/__init__", "parallel/mesh", "parallel/collectives",
            "parallel/sharding", "parallel/ring_attention", "parallel/moe",
            "parallel/pipeline", "tp_scaling_model")
#: the model zoo's modules, the weight bridge and the serving module
MODELS = ("models/__init__", "models/_layers", "models/lenet",
          "models/resnet", "models/bert", "models/widedeep",
          "models/inception", "models/unet", "convert", "serving",
          "training", "fleet")


def _run(code):
    env = dict(os.environ)
    env.pop("CUDA_HOME", None)
    env.pop("CUDA_PATH", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_serves_with_jax_unimportable():
    res = _run("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import torch
        from tensorflowonspark_tpu_torch import serving
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        from tensorflowonspark_tpu_torch import generation, kvship

        model = DecoderLM(32, hidden=16, num_heads=2, num_layers=2,
                          max_len=32)
        model.init_weights(torch.Generator().manual_seed(0))
        with serving.DecodeEngine(model, slots=2, device="cpu") as eng:
            out = eng.generate([1, 2, 3], 4, timeout=120)
            # a tenant-tagged request over HTTP, then a /metrics scrape
            import http.client, json
            with serving.ModelServer(None, name="lm", port=0,
                                     engine=eng) as srv:
                conn = http.client.HTTPConnection(*srv.address)
                conn.request("POST", "/v1/models/lm:generate", json.dumps(
                    {"prompt": [1, 2, 3], "max_new_tokens": 4,
                     "tenant": "alpha", "priority": "high"}))
                assert json.loads(conn.getresponse().read()) == \
                    {"tokens": out}
                conn.request("GET", "/metrics")
                text = conn.getresponse().read().decode()
            assert 'tfos_qos_tokens_total{tenant="alpha"} 4' in text
            assert text.rstrip().endswith("# EOF")
        assert len(out) == 7 and out[:3] == [1, 2, 3], out
        # a speculative request, and solo generate on the contiguous cache
        with serving.DecodeEngine(model, slots=2, speculate_k=3,
                                  device="cpu") as eng:
            assert eng.generate([1, 2, 3], 4, timeout=120) == out
        assert generation.generate(model, [[1, 2, 3]], 4,
                                   device="cpu")[0].tolist() == out
        # one splice: prefill and export on one engine, ship the packed
        # chain's bytes, splice into another, decode the same tokens
        prompt = list(range(1, 21))
        with serving.DecodeEngine(model, slots=2, kv_block_size=8,
                                  device="cpu") as a:
            want = a.generate(prompt, 3, timeout=120)
            buffers, _ = a.export_prefix(prompt)
        meta, rows = kvship.unpack(b"".join(bytes(b) for b in buffers))
        with serving.DecodeEngine(model, slots=2, kv_block_size=8,
                                  device="cpu") as b:
            assert b.import_prefix(meta, rows)["spliced_blocks"] == 2
            assert b.generate(prompt, 3, timeout=120) == want
        # a one-replica fleet: formed, supervised, autoscaled, routed,
        # drained, stopped
        from tensorflowonspark_tpu_torch import autoscale, fleet, supervisor
        kw = {"slots": 2, "device": "cpu"}
        with fleet.ServingFleet(model, replicas=1, name="lm",
                                engine_kw=kw) as f:
            assert isinstance(f.supervise(), supervisor.Supervisor)
            assert isinstance(f.autoscale(autoscale.AutoscalePolicy(
                max_replicas=1), interval=0.05),
                autoscale.AutoscaleController)
            host, port = f.router_addr
            conn = http.client.HTTPConnection(host, port)
            conn.request("POST", "/v1/models/lm:generate", json.dumps(
                {"prompt": [1, 2, 3], "max_new_tokens": 4}))
            assert json.loads(conn.getresponse().read()) == \
                {"tokens": out}
            assert f.rolling_drain()["zero_loss"]
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_port_trains_with_jax_unimportable():
    res = _run("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import torch
        from tensorflowonspark_tpu_torch import infeed, training
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        model = DecoderLM(32, hidden=16, num_heads=2, num_layers=1,
                          max_len=128)
        trainer = training.Trainer(model, training.adamw(1e-2),
                                   device="cpu")
        state = trainer.init(torch.Generator().manual_seed(0))
        rows = np.random.RandomState(0).randint(0, 32, (3, 2, 129))
        feed = ({"x": r[:, :-1], "y": r[:, 1:]} for r in rows)
        state, steps, rate = trainer.train_loop(
            state, infeed.device_batches(feed, device="cpu"))
        assert steps == 3 and state["step"] == 3 and rate > 0
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_port_file_imports_jax_or_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    bad = [(f, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_plane_modules_are_the_ports_own_and_import_no_torch():
    """Every module of the cluster and feed plane exists in the port,
    imports nothing forbidden, and none imports torch at module scope:
    the executor process that runs them forks the trainer, which must
    be the first process to touch CUDA."""
    for name in PLANE:
        path = os.path.join(PORT, name + ".py")
        assert os.path.isfile(path), path
        mods = list(_imports(path))
        assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], name
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))]
        scoped = [a.name for n in top if isinstance(n, ast.Import)
                  for a in n.names] + [n.module for n in top
                                       if isinstance(n, ast.ImportFrom)
                                       and n.module]
        assert not [m for m in scoped if m.split(".")[0] == "torch"], name


def test_cluster_runs_with_jax_unimportable(tmp_path):
    """A one-executor SPARK-mode job, driven from a process where jax,
    flax, optax, the JAX package and cloudpickle cannot be imported: the
    trainer sums its feed and the executor never creates a CUDA
    context."""
    res = _run("""
        import json, os, sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu", "cloudpickle"):
            sys.modules[name] = None  # any import of them now fails
        from tensorflowonspark_tpu_torch import cluster
        from tensorflowonspark_tpu_torch.engine import Context

        out = {out!r}

        def map_fun(args, ctx):
            feed = ctx.get_data_feed(train_mode=True)
            total = 0
            for batch in feed.numpy_batches(4):
                total += sum(batch)
            with open(args["out"], "w") as f:
                json.dump({{"total": total}}, f)

        def probe(it):
            import torch
            list(it)
            return [torch.cuda.is_initialized()]

        sc = Context(num_executors=1, work_root={root!r})
        try:
            tfc = cluster.run(sc, map_fun, {{"out": out}}, 1)
            tfc.train(sc.parallelize(list(range(30)), 3))
            cuda = sc.parallelize([0], 1).mapPartitions(probe).collect()
            tfc.shutdown()
        finally:
            sc.stop()
        assert json.load(open(out)) == {{"total": sum(range(30))}}
        assert cuda == [False], cuda
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "cloudpickle",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """.format(out=str(tmp_path / "total.json"),
               root=str(tmp_path / "engine")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_supervised_recovery_runs_with_jax_unimportable(tmp_path):
    """``cluster.run(supervise=)`` with a trainer SIGKILLed after step 2
    (``kill_trainer_at_step``), driven from a process where the JAX
    package cannot be imported: ``RestartFromCheckpoint`` reforms, the
    trainer restores its numpy checkpoint and the job ends exactly once;
    ``tracing.trace`` and ``start_profiler_server`` work there too."""
    res = _run("""
        import json, os, sys, urllib.request
        for name in ("jax", "jaxlib", "flax", "optax", "orbax",
                     "tensorflowonspark_tpu", "cloudpickle"):
            sys.modules[name] = None  # any import of them now fails
        from tensorflowonspark_tpu_torch import (chaos, cluster, supervisor,
                                                 tracing)
        from tensorflowonspark_tpu_torch.engine import Context

        root = {root!r}

        def map_fun(args, ctx):
            import numpy as np
            from tensorflowonspark_tpu_torch import checkpoint, supervisor
            ckpt = checkpoint.Checkpointer(args["dir"])
            like = {{"step": np.array(0, np.int32),
                     "seen": np.array(0.0, np.float64)}}
            restored = ckpt.restore(like, fallback=True)
            state = restored if restored is not None else like
            step = int(state["step"])
            sup = supervisor.attach(
                ctx, restored_step=step if restored is not None else None)
            feed = ctx.get_data_feed(train_mode=True)
            while not feed.should_stop():
                batch = feed.next_batch(4)
                if not batch:
                    continue
                step += 1
                state = {{"step": np.array(step, np.int32),
                          "seen": np.array(float(state["seen"]) + sum(batch),
                                           np.float64)}}
                ckpt.save(step, state)
                sup.step(step)
            with open(os.path.join(args["dir"], "final.json"), "w") as f:
                json.dump({{"step": step, "seen": float(state["seen"])}}, f)

        os.makedirs(os.path.join(root, "ckpt"))
        fuse = os.path.join(root, "fuse")
        sc = Context(num_executors=1, work_root=os.path.join(root, "engine"),
                     executor_env={{"TFOS_FEED_TRANSPORT": "queue",
                                    chaos.ENV_VAR:
                                    "kill_trainer_at_step=2,fuse=" + fuse}})
        cfg = supervisor.SupervisorConfig(
            policy=supervisor.RestartFromCheckpoint(max_restarts=2,
                                                    backoff=0.1),
            heartbeat_interval=0.25, heartbeat_timeout=20.0,
            poll_interval=0.1, classify_grace=10.0)
        try:
            tfc = cluster.run(sc, map_fun, {{"dir": os.path.join(root,
                                                                 "ckpt")}},
                              1, supervise=cfg)
            tfc.train(sc.parallelize(list(range(16)), 4), feed_timeout=60)
        finally:
            sc.stop()
        rep = tfc.report()
        assert os.path.exists(fuse)
        assert rep["formations"] == 2, rep
        assert [f["kind"] for f in rep["failures"]] == ["trainer_crash"]
        final = json.load(open(os.path.join(root, "ckpt", "final.json")))
        assert final == {{"step": 4, "seen": float(sum(range(16)))}}, final
        import torch
        with tracing.trace(os.path.join(root, "trace")) as tr:
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        assert os.path.exists(tr.path)
        port = tracing.start_profiler_server(0, log_dir=root)
        got = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/capture?ms=20" % port, timeout=60).read())
        assert os.path.exists(got["trace"])
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "orbax",
                                         "cloudpickle",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """.format(root=str(tmp_path)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_pipeline_runs_with_jax_unimportable(tmp_path):
    """The slice's path in a process where jax, flax, optax, orbax, the
    JAX package and cloudpickle cannot be imported: ``dfutil`` writes
    TFRecords, ``TFEstimator`` fits in TENSORFLOW mode (native codec
    read, a checkpoint saved and restored, a chief export), and
    ``TFModel.transform`` scores from the export. None of the forbidden
    modules is loaded in the driver, the executor or the trainer."""
    res = _run("""
        import json, os, sys
        BANNED = ("jax", "jaxlib", "flax", "optax", "orbax",
                  "tensorflowonspark_tpu", "cloudpickle")
        for name in BANNED:
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        from tensorflowonspark_tpu_torch import dfutil, pipeline
        from tensorflowonspark_tpu_torch.engine import Context

        work = {work!r}

        def foreign():
            return sorted(m for m in sys.modules
                          if m.split(".")[0] in BANNED
                          and sys.modules[m] is not None)

        def apply_fn(variables, batch):
            import torch
            from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
            skeleton = DecoderLM(32, hidden=16, num_heads=2, num_layers=1,
                                 max_len=128, device="meta")
            with torch.no_grad():
                logits = torch.func.functional_call(skeleton, variables,
                                                    (batch["x"],))
            return {{"next_token": logits[:, -1].argmax(-1)}}

        def train_fn(args, ctx):
            import numpy as np
            import torch
            from tensorflowonspark_tpu_torch import (checkpoint, tfnode,
                                                     tfrecord, training)
            from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

            dev = ctx.initialize_torch("cpu")
            rows = np.concatenate([
                tfrecord.read_batch(f, {{"tokens": ("int64", 129)}})["tokens"]
                for f in tfrecord.list_tfrecord_files(args.tfrecord_dir)])
            batches = [{{"x": rows[i:i + 2, :-1], "y": rows[i:i + 2, 1:]}}
                       for i in range(0, len(rows), 2)]
            model = DecoderLM(32, hidden=16, num_heads=2, num_layers=1,
                              max_len=128)
            tr = training.Trainer(model, training.adamw(1e-2), device=dev)
            state = tr.init(torch.Generator().manual_seed(0))
            ckpt = checkpoint.Checkpointer(args.model_dir)
            state, steps, _ = tr.train_loop(
                state, iter(batches), log_every=0,
                hooks=(checkpoint.hook(ckpt, every_steps=2),))
            state = ckpt.restore(tr.init(torch.Generator().manual_seed(9)))
            tfnode.export_saved_model(args.export_dir, apply_fn,
                                      model.state_dict())
            with open(os.path.join(work, "trainer.json"), "w") as f:
                json.dump({{"steps": steps, "restored": state["step"],
                           "native": tfrecord.codec_reads["native"],
                           "foreign": foreign()}}, f)

        def probe(it):
            list(it)
            return [foreign()]

        sc = Context(num_executors=1, work_root=os.path.join(work, "eng"))
        try:
            rows = np.random.RandomState(0).randint(0, 32, (4, 129))
            df = sc.createDataFrame([{{"tokens": r}} for r in rows],
                                    num_slices=2)
            dfutil.saveAsTFRecords(df, os.path.join(work, "recs"))
            fitted = (pipeline.TFEstimator(train_fn)
                      .setInputMode("tensorflow")
                      .setTfrecordDir(os.path.join(work, "recs"))
                      .setModelDir(os.path.join(work, "ckpt"))
                      .setExportDir(os.path.join(work, "export"))
                      .fit(df))
            model = pipeline.TFModel(vars(fitted.merged_args()),
                                     device="cpu")
            model.setInputMapping({{"tokens": "x"}})
            model.setOutputMapping({{"next_token": "next_token"}})
            held = sc.createDataFrame(
                [{{"tokens": r[:128]}} for r in rows], num_slices=2)
            scored = model.transform(held).collect()
            executor = sc.parallelize([0], 1).mapPartitions(probe).collect()
        finally:
            sc.stop()
        got = json.load(open(os.path.join(work, "trainer.json")))
        assert got["steps"] == 2 and got["restored"] == 2, got
        assert got["native"] == 2 and got["foreign"] == [], got
        assert len(scored) == 4 and executor == [[]], (scored, executor)
        assert foreign() == [], foreign()
        print("OK")
    """.format(work=str(tmp_path)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel wrapper and its builder runs no compiler and
    loads no library: the build happens at the first launch."""
    res = _run("""
        import subprocess

        def refuse(*a, **k):
            raise AssertionError("a compiler ran at import time")

        subprocess.Popen = refuse
        subprocess.run = refuse
        from tensorflowonspark_tpu_torch import infeed, training
        from tensorflowonspark_tpu_torch.ops import _build
        from tensorflowonspark_tpu_torch.ops import flash_attention
        from tensorflowonspark_tpu_torch.ops import paged_attention
        assert _build._libs == {}
        assert paged_attention.launches == 0
        assert flash_attention.launches == {"fwd": 0, "dq": 0, "dkv": 0}
        assert set(_build.KERNELS) == {"paged_attention", "flash_attention",
                                       "wide_attention"}
        assert set(_build.KERNELS["flash_attention"]) == {
            "tfos_flash_fwd", "tfos_flash_dq", "tfos_flash_dkv",
            "tfos_flash_budget"}
        assert set(_build.KERNELS["wide_attention"]) == {
            "tfos_wide_flash_fwd", "tfos_wide_flash_dq",
            "tfos_wide_flash_dkv", "tfos_wide_paged_split",
            "tfos_wide_paged_tiled", "tfos_wide_budget"}
        for name in _build.KERNELS:
            assert _build.library_path(name).endswith(".so")
        print("OK")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


#: the concurrency lint's modules (the port's own copy)
ANALYSIS = ("analysis/__init__", "analysis/__main__", "analysis/core",
            "analysis/guards", "analysis/lockorder", "analysis/lifecycle",
            "analysis/racecheck", "analysis/report")


def test_analysis_is_the_ports_own_and_lints_with_jax_unimportable():
    """Every module of the port's concurrency lint exists, imports only
    the standard library and itself (statically), and ``python -m
    tensorflowonspark_tpu_torch.analysis`` runs in a process where jax,
    flax, optax and the JAX package cannot be imported: the port's
    package against its own baseline, no new finding."""
    for name in ANALYSIS:
        path = os.path.join(PORT, name + ".py")
        assert os.path.isfile(path), path
        mods = [m.split(".")[0] for m in _imports(path)]
        assert set(mods) <= {"ast", "argparse", "json", "os", "re", "sys",
                             "tensorflowonspark_tpu_torch"}, (name, mods)
    res = _run("""
        import runpy, sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu", "torch"):
            sys.modules[name] = None  # any import of them now fails
        sys.argv = ["analysis"]
        try:
            runpy.run_module("tensorflowonspark_tpu_torch.analysis",
                             run_name="__main__")
        except SystemExit as e:
            print("rc", e.code)
    """)
    assert res.returncode == 0, res.stderr
    assert "0 new" in res.stdout and "10 baselined" in res.stdout, res.stdout
    assert res.stdout.strip().endswith("rc 0"), res.stdout


def test_model_modules_are_the_ports_own():
    """Every zoo module exists in the port and imports nothing of JAX,
    flax, optax or the JAX package (statically)."""
    for name in MODELS:
        path = os.path.join(PORT, name + ".py")
        assert os.path.isfile(path), path
        bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
        assert not bad, (name, bad)


def test_model_zoo_and_predict_run_with_jax_unimportable(tmp_path):
    """Each family's forward and a training step, and ``:predict`` of an
    exported BERT through ``ModelServer(model_dir)`` with the batching
    window, from a process where jax, flax, optax and the JAX package
    cannot be imported."""
    res = _run("""
        import http.client, json, os, sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import torch
        from tensorflowonspark_tpu_torch import convert, export, serving
        from tensorflowonspark_tpu_torch import training
        from tensorflowonspark_tpu_torch.models import (
            bert, inception, lenet, resnet, unet, widedeep)

        g = torch.Generator().manual_seed(0)
        rng = np.random.RandomState(0)
        img = lambda b, s, c=3: torch.from_numpy(
            rng.rand(b, s, s, c).astype(np.float32))
        cases = [
            (lenet.LeNet(), (img(2, 28, 1),), (2, 10)),
            (resnet.ResNet(stage_sizes=[1, 1], width=4, num_classes=3),
             (img(2, 32),), (2, 3)),
            (unet.UNet(2, features=(4, 8)), (img(2, 16),), (2, 16, 16, 2)),
            (widedeep.WideDeep(hash_buckets=5, embed_dim=4,
                               mlp_sizes=(8,)),
             (torch.rand(2, 13), torch.randint(0, 5, (2, 26))), (2,)),
            (inception.InceptionV3(num_classes=3), (img(2, 75),), (2, 3)),
        ]
        for model, inputs, shape in cases:
            model.init_weights(g)
            model.train()
            out = model(*inputs)
            out.float().sum().backward()
            model.eval()
            with torch.no_grad():
                out = model(*inputs)
            assert tuple(out.shape) == shape, (type(model), out.shape)
            assert torch.isfinite(out).all()
        # a Wide & Deep training step and its int8 tables
        wd = widedeep.WideDeep(hash_buckets=5, embed_dim=4, mlp_sizes=(8,))
        tr = training.Trainer(wd, training.adamw(1e-2),
                              loss_fn=widedeep.ctr_loss,
                              input_keys=("dense", "cat"), device="cpu")
        state = tr.init(torch.Generator().manual_seed(0))
        batch = {"dense": np.ones((4, 13), np.float32),
                 "cat": np.zeros((4, 26), np.int64),
                 "label": np.ones(4, np.int64)}
        state, m = tr.step(state, batch)
        slim, quant = widedeep.quantize_embeddings(wd.state_dict())
        assert quant["deep_embeddings.table"].dtype == torch.int8
        params, extra = convert.widedeep_to_flax(dict(slim, **quant))
        assert "quant" in extra
        # BERT exported and served through the window
        cfg = bert.bert_tiny()
        model = bert.BertForQuestionAnswering(cfg).init_weights(g)

        def apply_fn(variables, batch):
            import torch
            from tensorflowonspark_tpu_torch.models import bert as b
            sk = b.BertForQuestionAnswering(b.bert_tiny(),
                                            device="meta").eval()
            ids = torch.as_tensor(batch["input_ids"])
            mask = torch.as_tensor(batch["attention_mask"])
            s, e = torch.func.functional_call(sk, variables, (ids, mask))
            return {"start": s, "end": e}

        d = os.path.join(WORK, "bert_export")
        export.save_model(d, apply_fn, model.state_dict())
        with serving.ModelServer(d, name="qa", port=0, device="cpu",
                                 batch_window_ms=5) as srv:
            conn = http.client.HTTPConnection("127.0.0.1", srv.address[1],
                                              timeout=120)
            rows = [{"input_ids": list(range(16)),
                     "attention_mask": [1] * 16}] * 2
            conn.request("POST", "/v1/models/qa:predict",
                         body=json.dumps({"instances": rows}))
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200, body
            assert len(body["predictions"]) == 2
            assert len(body["predictions"][0]["start"]) == 16
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "optax",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """.replace("WORK", repr(str(tmp_path))))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def _example_files():
    return sorted(os.path.join(d, n) for d, _, names in os.walk(EXAMPLES)
                  for n in names if n.endswith(".py"))


def test_example_drivers_import_no_torch_at_module_scope():
    """Every example driver is the port's own and imports torch only
    inside its functions: the driver and the executors that import it
    never touch CUDA; only a forked trainer does."""
    files = _example_files()
    drivers = [os.path.relpath(f, EXAMPLES) for f in files
               if not os.path.basename(f).startswith("_")]
    assert len(drivers) == 15, drivers
    for path in files:
        mods = list(_imports(path))
        assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], path
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = [a.name for n in tree.body if isinstance(n, ast.Import)
               for a in n.names] + [n.module for n in tree.body
                                    if isinstance(n, ast.ImportFrom)
                                    and n.module]
        assert not [m for m in top if m.split(".")[0] == "torch"], path


def test_cluster_api_and_examples_run_with_jax_unimportable(tmp_path):
    """From a process where jax, flax, optax, the JAX package and
    cloudpickle cannot be imported: every example driver imports, a
    ``StreamingContext.queueStream`` feeds a one-executor cluster through
    ``tfc.train(dstream)`` and ``shutdown(ssc)``, ``parallel_runner.run``
    returns its job's value, and the Spark adapter binds a SparkContext
    stand-in; none of the forbidden modules is loaded."""
    res = _run("""
        import importlib, json, os, queue, sys, time
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu", "cloudpickle"):
            sys.modules[name] = None  # any import of them now fails
        sys.path.insert(0, os.path.join({root!r}, "tests", "fakes"))
        import pyspark  # the in-tree stand-in
        from tensorflowonspark_tpu_torch import cluster, parallel_runner
        from tensorflowonspark_tpu_torch.engine import (
            Context, StreamingContext, spark_adapter)

        for d, _, names in os.walk({examples!r}):
            for n in sorted(names):
                if n.endswith(".py"):
                    rel = os.path.relpath(os.path.join(d, n), {root!r})
                    mod = rel[:-3].replace(os.sep, ".")
                    importlib.import_module(mod.replace(".__init__", ""))

        out = {out!r}

        def map_fun(args, ctx):
            feed = ctx.get_data_feed(train_mode=True)
            total = 0
            for batch in feed.numpy_batches(4):
                total += sum(batch)
            with open(args["out"], "w") as f:
                json.dump({{"total": total}}, f)

        def job(args, index):
            import torch
            return float(torch.tensor(float(index + args)) ** 2)

        sc = Context(num_executors=1, work_root={work!r})
        try:
            tfc = cluster.run(sc, map_fun, {{"out": out}}, 1)
            ssc = StreamingContext(sc, batch_interval=0.05)
            q = queue.Queue()
            tfc.train(ssc.queueStream(q))
            ssc.start()
            q.put(sc.parallelize(list(range(12)), 2))
            q.put(sc.parallelize(list(range(12, 20)), 2))
            tfc.shutdown(ssc)
            got = parallel_runner.run(sc, job, 3, 1)
        finally:
            sc.stop()
        assert json.load(open(out)) == {{"total": sum(range(20))}}
        assert got == [9.0], got
        eng = spark_adapter.from_spark(pyspark.SparkContext("local[2]"), 2)
        assert sorted(eng.parallelize(range(4), 2).collect()) == [0, 1, 2, 3]
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "cloudpickle",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """.format(root=ROOT, examples=EXAMPLES,
               out=str(tmp_path / "total.json"),
               work=str(tmp_path / "engine")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_parallel_modules_are_the_ports_own():
    """Every module of the parallel package exists in the port and
    imports nothing of JAX, flax, optax or the JAX package (statically);
    the mesh module imports no torch at module scope (the supervisor's
    resize arithmetic runs in processes that never touch a device)."""
    for name in PARALLEL:
        path = os.path.join(PORT, name + ".py")
        assert os.path.isfile(path), path
        bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
        assert not bad, (name, bad)
    with open(os.path.join(PORT, "parallel", "mesh.py")) as f:
        tree = ast.parse(f.read())
    top = [a.name for n in tree.body if isinstance(n, ast.Import)
           for a in n.names] + [n.module for n in tree.body
                                if isinstance(n, ast.ImportFrom)
                                and n.module]
    assert not [m for m in top if m.split(".")[0] == "torch"], top


def test_parallel_and_its_examples_run_with_jax_unimportable(tmp_path):
    """From a process where jax, flax, optax and the JAX package cannot
    be imported: the parallel package imports without starting a process
    group, the 4-way lockstep ring trains a step's gradients, the
    long-context driver learns on a one-rank ring (a gloo group it starts
    and ends), MoE, the pipeline and TP decode run on one-rank meshes
    (the decode step's traffic recorded: none on one rank), and the
    Criteo driver trains on one executor and exports its int8 model."""
    res = _run("""
        import json, os, sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "tensorflowonspark_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import torch
        import torch.distributed as dist
        import tensorflowonspark_tpu_torch.parallel as par
        from tensorflowonspark_tpu_torch.parallel import (
            moe, pipeline, ring_attention, sharding)
        assert not dist.is_initialized()

        q = torch.randn(1, 64, 2, 16, requires_grad=True)
        out = ring_attention._ring_lockstep(q, q, q, 4, causal=True,
                                            block_q=8, block_k=8,
                                            layout="zigzag")
        out.sum().backward()
        assert torch.isfinite(q.grad).all()

        from tensorflowonspark_tpu_torch.examples.longcontext import (
            train_long)
        train_long.main(["--seq_len", "128", "--steps", "8", "--hidden",
                         "16", "--layers", "1", "--period", "7",
                         "--device", "cpu"])
        assert not dist.is_initialized()

        mesh = par.build_mesh({"expert": 1}, device="cpu")
        g = torch.Generator().manual_seed(0)
        r, wi, wo = moe.init_moe_params(g, 4, 8, 16)
        y, aux = moe.moe_ffn(torch.randn(6, 8), r, wi, wo, mesh)
        assert y.shape == (6, 8) and float(aux) > 0
        smesh = par.build_mesh({"stage": 1}, device="cpu")
        xs, w = torch.randn(3, 2, 8), torch.randn(8, 8) * 0.3
        ys = pipeline.pipeline_apply(lambda p, h: torch.tanh(h @ p), w, xs,
                                     smesh)
        assert torch.allclose(ys, torch.tanh(xs @ w))
        # TP decode on a one-rank model axis, its step's traffic recorded
        from tensorflowonspark_tpu_torch import generation, tp_scaling_model
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
        lm = DecoderLM(32, hidden=16, num_heads=2, num_layers=2, max_len=16)
        lm.init_weights(torch.Generator().manual_seed(0))
        want = generation.generate(lm, [[1, 2, 3]], 4, device="cpu")
        sharding.distribute_params(
            lm, par.build_mesh({"model": 1}, device="cpu"),
            sharding.DECODER_TP_RULES)
        assert torch.equal(generation.generate(lm, [[1, 2, 3]], 4,
                                               device="cpu"), want)
        assert tp_scaling_model.decode_step_traffic(
            lm, [[1, 2, 3]], device="cpu")["bytes"] == 0
        dist.destroy_process_group()

        from tensorflowonspark_tpu_torch.examples.criteo import criteo_spark
        os.chdir(WORK)
        criteo_spark.main(["--cluster_size", "1", "--num_examples", "128",
                           "--batch_size", "32", "--epochs", "1",
                           "--quantize_export", "wd_int8", "--device",
                           "cpu"])
        stats = json.load(open(os.path.join("widedeep_model",
                                            "train_stats.json")))
        assert stats["steps"] > 0, stats
        assert os.path.isfile(os.path.join("wd_int8", "variables.pt"))
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "optax",
                                         "tensorflowonspark_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("OK")
    """.replace("WORK", repr(str(tmp_path))))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert res.stdout.strip().endswith("OK")

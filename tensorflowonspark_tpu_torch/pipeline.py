"""ML-pipeline layer: Estimator/Model with Spark-ML-shaped params — the
port's copy of ``tensorflowonspark_tpu/pipeline.py``.

Reference: ``tensorflowonspark/pipeline.py`` (SURVEY.md §2 "Spark ML
Pipeline", §3.4): ~15 ``HasXxx`` param mixins, a ``Namespace``/``TFParams``
merger, ``TFEstimator(train_fn, tf_args)._fit(df)`` spinning up a cluster,
and ``TFModel._transform(df)`` doing single-node parallel inference with a
per-process cached loaded model (no cluster).

The export format is :mod:`tensorflowonspark_tpu_torch.export`
(apply_fn + a ``state_dict``), replacing TF SavedModel signatures; the
input/output column mapping semantics are unchanged. ``TFModel`` runs
the export on the card (the executor's first CUDA call happens there:
run it after any cluster whose trainers are forked from the same
executors has shut down) unless it is built with ``device="cpu"``; each
batch reaches ``apply_fn`` as tensors on that device, and its outputs
come back to the host.

Nothing is left out: ``Namespace``, the params surface, ``TFEstimator``
(both input modes) and ``TFModel`` are all here.
"""

import copy
import logging

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine.dataframe import DataFrame

logger = logging.getLogger(__name__)


class Namespace(object):
    """Attribute bag, argparse-Namespace compatible (reference:
    ``pipeline.Namespace``): construct from a dict or another namespace."""

    def __init__(self, d=None, **kwargs):
        if d is not None:
            self.__dict__.update(d if isinstance(d, dict) else vars(d))
        self.__dict__.update(kwargs)

    def __contains__(self, key):
        return key in self.__dict__

    def __iter__(self):
        return iter(self.__dict__)

    def __eq__(self, other):
        return isinstance(other, Namespace) and vars(self) == vars(other)

    def __repr__(self):  # pragma: no cover - debug aid
        return "Namespace({})".format(self.__dict__)


def _param(name, default=None, doc=""):
    """Generate a Spark-ML-style param property + setter/getter pair."""

    private = "_" + name

    def getter(self):
        return getattr(self, private, default)

    def setter(self, value):
        setattr(self, private, value)
        return self

    return getter, setter


class _ParamsBase(object):
    """Spark-ML param plumbing: setXxx/getXxx for every declared param.

    Reference: the ``HasXxx`` mixin family + ``TFParams``. Params are
    declared in ``PARAMS`` as (name, default); accessors are generated
    (``setBatchSize``/``getBatchSize`` for ``batch_size``), and ``merge``
    folds the set values into the user's args namespace the way
    ``TFParams.merge_args_params`` does.
    """

    PARAMS = ()

    def __init__(self, tf_args=None):
        self.args = Namespace(tf_args) if tf_args is not None else Namespace()
        self._set_params = {}

    def _set(self, name, value):
        self._set_params[name] = value
        return self

    def _get(self, name):
        if name in self._set_params:
            return self._set_params[name]
        for pname, default in type(self).PARAMS:
            if pname == name:
                return getattr(self.args, name, default)
        raise KeyError(name)

    def __getattr__(self, attr):
        # setBatchSize / getBatchSize style accessors
        if attr.startswith(("set", "get")) and len(attr) > 3:
            snake = _camel_to_snake(attr[3:])
            if any(p == snake for p, _ in type(self).PARAMS):
                if attr.startswith("set"):
                    return lambda value: self._set(snake, value)
                return lambda: self._get(snake)
        raise AttributeError(attr)

    def merged_args(self):
        """args namespace + every explicitly set param (param wins)."""
        merged = Namespace(self.args)
        for pname, default in type(self).PARAMS:
            if getattr(merged, pname, None) is None:
                setattr(merged, pname, default)
        merged.__dict__.update(self._set_params)
        return merged


def _camel_to_snake(name):
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


#: the reference's HasXxx surface (SURVEY.md §2 pipeline row)
_COMMON_PARAMS = (
    ("batch_size", 100),
    ("epochs", 1),
    ("cluster_size", 1),
    ("num_ps", 0),
    ("input_mode", "spark"),
    ("input_mapping", None),      # {df column -> feed name}
    ("output_mapping", None),     # {model output -> df column}
    ("model_dir", None),
    ("export_dir", None),
    ("signature_def_key", "serving_default"),
    ("tag_set", "serve"),
    ("protocol", "grpc"),
    ("tensorboard", False),
    ("master_node", "chief"),
    ("tfrecord_dir", None),
    ("grace_secs", 0),
)


class TFEstimator(_ParamsBase):
    """Train on a DataFrame via a cluster; produces a :class:`TFModel`.

    Reference: ``pipeline.TFEstimator(train_fn, tf_args, export_fn)``.
    ``train_fn(args, ctx)`` is a normal map_fun; it should export to
    ``args.export_dir`` on the chief (via ``export.save_model``).
    """

    PARAMS = _COMMON_PARAMS

    def __init__(self, train_fn, tf_args=None, export_fn=None):
        super(TFEstimator, self).__init__(tf_args)
        self.train_fn = train_fn
        self.export_fn = export_fn

    def fit(self, df):
        return self._fit(df)

    def _fit(self, df):
        args = self.merged_args()
        sc = df.rdd.ctx
        logger.info("TFEstimator.fit: cluster_size=%d input_mode=%s",
                    args.cluster_size, args.input_mode)
        input_mode = (cluster.InputMode.SPARK if args.input_mode == "spark"
                      else cluster.InputMode.TENSORFLOW)
        tfc = cluster.run(sc, self.train_fn, args,
                          num_executors=args.cluster_size,
                          num_ps=args.num_ps,
                          tensorboard=args.tensorboard,
                          input_mode=input_mode,
                          log_dir=args.model_dir,
                          master_node=args.master_node)
        if input_mode == cluster.InputMode.SPARK:
            # feed rows as input_mapping-ordered tuples (reference behavior:
            # df columns selected per input_mapping, in mapping order)
            mapping = args.input_mapping or {c: c for c in df.columns}
            cols = list(mapping.keys())
            rdd = df.rdd.map(lambda row, _c=tuple(cols):
                             [row[k] for k in _c])
            tfc.train(rdd, num_epochs=args.epochs)
        tfc.shutdown(grace_secs=args.grace_secs)
        return TFModel(copy.deepcopy(vars(args)))


class TFModel(_ParamsBase):
    """Single-node parallel inference over DataFrame partitions.

    Reference: ``pipeline.TFModel._transform`` — no cluster; every
    executor loads (and caches) the exported model, maps ``input_mapping``
    columns to model inputs, batches rows, emits ``output_mapping``
    columns (SURVEY.md §3.4).

    ``device``: where the export runs (``device_info.default_device``'s
    argument: the card unless ``"cpu"`` is asked for).
    """

    PARAMS = _COMMON_PARAMS

    def __init__(self, tf_args=None, device=None):
        super(TFModel, self).__init__(tf_args)
        self.device = device

    def transform(self, df):
        return self._transform(df)

    def _transform(self, df):
        args = self.merged_args()
        if not args.export_dir:
            raise ValueError("TFModel requires export_dir")
        in_mapping = args.input_mapping or {}
        out_mapping = args.output_mapping or {}
        export_dir = args.export_dir
        batch_size = args.batch_size
        device = None if self.device is None else str(self.device)

        def _run_model(iterator):
            # cached per executor process (export.load_model caches)
            import numpy as np
            import torch

            from tensorflowonspark_tpu_torch import device_info
            from tensorflowonspark_tpu_torch import export as export_lib

            dev = device_info.default_device(device)
            apply_fn, variables, signature = export_lib.load_model(
                export_dir, device=dev)
            inputs = in_mapping or {c: c for c in signature.get("inputs", [])}
            outputs = out_mapping or {
                c: c for c in signature.get("outputs", [])}

            import itertools

            it = iter(iterator)
            while True:
                chunk = list(itertools.islice(it, batch_size))
                if not chunk:
                    break
                batch = {feed: torch.as_tensor(
                    np.asarray([row[col] for row in chunk])).to(dev)
                    for col, feed in inputs.items()}
                result = apply_fn(variables, batch)
                if not isinstance(result, dict):
                    result = {"output": result}
                result = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                              else np.asarray(v)) for k, v in result.items()}
                n = len(chunk)
                for i in range(n):
                    out_row = {}
                    for model_out, col in outputs.items():
                        value = result[model_out][i]
                        out_row[col] = value.tolist() \
                            if value.ndim > 0 else value.item()
                    yield out_row

        result_rdd = df.rdd.mapPartitions(_run_model)

        # Honest output schema, lazily: dtypes come from the first real
        # result row (the way dfutil infers from the first Example) but
        # only if/when the schema is actually read — take(1) then costs a
        # single one-row task, and the loaded model stays cached on that
        # executor for the full pass. Empty input falls back to the
        # declared columns as float32.
        def _infer_output_schema():
            first = result_rdd.take(1)
            if first:
                from tensorflowonspark_tpu_torch.engine.dataframe import (
                    _infer_dtype)
                return [(c, _infer_dtype(v)) for c, v in first[0].items()]
            out_cols = list((out_mapping or {"output": "output"}).values())
            return [(c, "float32") for c in out_cols]

        return DataFrame(result_rdd, _infer_output_schema)

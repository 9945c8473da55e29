"""User-facing node helpers — the reference's ``TFNode`` module surface,
the port's copy of ``tensorflowonspark_tpu/tfnode.py``.

Reference: ``tensorflowonspark/TFNode.py``: ``DataFeed`` (re-exported
from :mod:`datafeed` here), ``hdfs_path``, ``start_cluster_server``,
``export_saved_model``. Kept as a module so reference-style user code
ports with an import swap::

    from tensorflowonspark_tpu_torch import tfnode as TFNode
    feed = TFNode.DataFeed(ctx.mgr, train_mode=True)

Nothing is left out: ``export_saved_model`` delegates to the port's
:mod:`export` module.
"""

import logging

from tensorflowonspark_tpu_torch.datafeed import DataFeed  # noqa: F401

logger = logging.getLogger(__name__)


def hdfs_path(ctx, path):
    """Absolutize a user path against the cluster's default FS/working dir.

    Reference: ``TFNode.hdfs_path(ctx, path)``.
    """
    return ctx.absolute_path(path)


def start_cluster_server(ctx, num_devices=1, protocol=None):
    """Join the device collective; returns the trainer's ``torch.device``.

    Reference: TF1-era ``TFNode.start_cluster_server(ctx, num_gpus, rdma)``
    built a ``tf.train.Server`` (grpc / grpc+verbs). Here the transport is
    ``torch.distributed`` (NCCL on the card, gloo on the CPU) — ``protocol``
    is accepted and ignored for parity — and 'starting the server' is
    :meth:`NodeContext.initialize_torch`.
    """
    if protocol not in (None, "grpc"):
        logger.warning("protocol=%r has no counterpart here (the "
                       "collective backend is torch.distributed's); "
                       "ignoring", protocol)
    return ctx.initialize_torch()


def export_saved_model(export_dir, apply_fn, variables, signature=None):
    """Chief-side model export (reference: ``TFNode.export_saved_model``).

    Thin delegate to :func:`tensorflowonspark_tpu_torch.export.save_model`;
    the caller runs it on the chief.
    """
    from tensorflowonspark_tpu_torch import export

    export.save_model(export_dir, apply_fn, variables, signature)

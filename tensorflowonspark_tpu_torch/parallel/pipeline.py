"""Pipeline parallelism: GPipe-style microbatching over a ``stage`` axis —
the port of ``tensorflowonspark_tpu/parallel/pipeline.py``.

SURVEY.md §2.3: the reference has no PP; this is a mesh-native extension.
Each rank holds its own stage's parameters; activations flow
stage-to-stage by :class:`collectives.Shift` (the reference's
``ppermute``) in a static schedule of M + P - 1 ticks (fill + drain).
Every rank runs the same loop (SPMD), so there is no per-stage program —
the rank's position on the axis selects its role.
"""

import torch

from tensorflowonspark_tpu_torch.parallel.collectives import (
    KeepAlive, ReduceFromGroup, Shift, axis_of)


def pipeline_apply(stage_fn, stage_params, microbatches, mesh,
                   stage_axis="stage"):
    """Run microbatches through P pipeline stages.

    Args:
      stage_fn: ``(params_for_stage, x) -> y`` with y.shape == x.shape
        (equal-width stages — the classic PP layout).
      stage_params: THIS rank's stage parameters (any object
        ``stage_fn`` takes; the reference passes the stacked pytree and
        each device takes its slice).
      microbatches: [M, mb, ...] tensor (replicated input).
      mesh: a ``DeviceMesh`` with ``stage_axis``.

    Returns [M, mb, ...]: outputs of the last stage, replicated over the
    axis (a sum over the group in which only the last stage's term is
    nonzero; its backward hands the replicated gradient to the last
    stage). The gradient of ``microbatches`` reaches rank 0 only, the
    stage that reads them.
    """
    num_stages, rank, group = axis_of(mesh, stage_axis)
    num_micro = microbatches.shape[0]
    outputs = [None] * num_micro
    received = []
    ticks = num_micro + num_stages - 1
    # tick 0: stage 0 ingests microbatch 0, the others run on zeros (the
    # fill); the carry dtype is the stage OUTPUT dtype (may differ from
    # the input's, e.g. float32 activations out of bfloat16 inputs), so
    # a stage whose output dtype differs reruns on its input cast to it
    x_in = microbatches[0] if rank == 0 else torch.zeros_like(microbatches[0])
    y = stage_fn(stage_params, x_in)
    if y.dtype != x_in.dtype:
        y = stage_fn(stage_params, x_in.to(y.dtype))
    for t in range(ticks):
        if t:
            # stage 0 ingests microbatch t (while t < M); the others take
            # the activation shifted from their predecessor last tick
            x_in = (microbatches[min(t, num_micro - 1)].to(y.dtype)
                    if rank == 0 else carried)
            y = stage_fn(stage_params, x_in)
        # the last stage banks its result for microbatch t-(P-1)
        out_idx = t - (num_stages - 1)
        if rank == num_stages - 1 and out_idx >= 0:
            outputs[out_idx] = y
        if t + 1 < ticks:
            (carried,) = Shift.apply(group, 1, y)
            received.append(carried)
    if rank == num_stages - 1:
        banked = torch.stack(outputs)
    else:
        banked = torch.zeros((num_micro,) + tuple(y.shape), dtype=y.dtype,
                             device=y.device)
    if received and torch.is_grad_enabled():
        banked = KeepAlive.apply(banked, *received)
    # outputs are only real on the last stage; broadcast them
    return ReduceFromGroup.apply(banked, group)


def stack_stage_params(init_fn, generator, num_stages, sample_x):
    """P stage parameter sets, initialized one after another from
    ``generator``: ``[init_fn(generator, sample_x) for each stage]`` (the
    reference vmaps its init over split keys; rank ``i`` takes entry
    ``i``)."""
    return [init_fn(generator, sample_x) for _ in range(num_stages)]

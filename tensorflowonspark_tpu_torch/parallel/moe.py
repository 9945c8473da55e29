"""Mixture-of-Experts with expert parallelism over an ``expert`` axis —
the port of ``tensorflowonspark_tpu/parallel/moe.py``.

SURVEY.md §2.3: absent from the reference; a mesh-native extension.
Experts' FFN weights are sharded one block per rank over the ``expert``
axis (each rank passes its local ``[E/P, ...]`` slices); tokens are
routed with top-1 (switch-style) gating. Dispatch is the dense-einsum
formulation: each rank runs its resident experts over the FULL token set
and masks by the routing one-hots, then one all-reduce over the expert
group combines. That trades FLOPs (every expert sees every token — there
is no capacity truncation) for *zero* ragged communication and static
shapes. Right for moderate expert counts; a capacity-bounded all-to-all
dispatch is the later optimization for large E.

The reference's ``psum`` is :class:`collectives.ReduceFromGroup` here,
and the replicated token and gate values enter the rank-local expert
work through :class:`collectives.CopyToGroup`, so the gradients of the
replicated inputs (``x``, ``router_w``) come back whole and replicated
and each rank's expert-weight gradients are its slices of the full ones
— the gradients the reference's ``jax.grad`` gives. The products stay
``torch.einsum`` (the reference's are plain einsums too).
"""

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.parallel.collectives import (
    CopyToGroup, ReduceFromGroup, axis_of)


def gelu_tanh(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's
    ``F.gelu`` default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def top1_gating(logits):
    """[T, E] router logits -> (one_hot [T, E], probs [T], aux_loss).

    Aux loss is the switch-transformer load-balance term (mean gate prob *
    token fraction per expert, scaled by E^2 so perfectly balanced == 1).
    """
    num_experts = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    idx = probs.argmax(dim=-1)
    one_hot = F.one_hot(idx, num_experts).to(probs.dtype)
    gate = (probs * one_hot).sum(dim=-1)
    density = one_hot.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * (num_experts ** 2)
    return one_hot, gate, aux


def moe_ffn(x, router_w, w_in_local, w_out_local, mesh, expert_axis="expert",
            activation=gelu_tanh):
    """Expert-parallel FFN layer, on this rank's shards.

    Args:
      x: [tokens, hidden] (replicated over the expert axis).
      router_w: [hidden, E] routing weights (replicated).
      w_in_local: [E/P, hidden, ffn] this rank's expert up-projections
        (experts ``rank * E/P ...``).
      w_out_local: [E/P, ffn, hidden] its down-projections.
      mesh: a ``DeviceMesh`` with ``expert_axis``.

    Returns ([tokens, hidden], aux_loss), both replicated.
    """
    _, rank, group = axis_of(mesh, expert_axis)
    experts_per_rank = w_in_local.shape[0]

    logits = x @ router_w                               # [T, E]
    one_hot, gate, aux = top1_gating(logits)

    # mask of tokens routed to each of my local experts: [T, e_local]
    first = rank * experts_per_rank
    local_mask = one_hot[:, first:first + experts_per_rank]

    # dense dispatch: every rank runs its experts over all tokens,
    # masked — ragged all-to-all avoided, shapes static
    xe = CopyToGroup.apply(x, group)
    ge = CopyToGroup.apply(gate, group)
    h = activation(torch.einsum("th,ehf->etf", xe, w_in_local))
    y_local = torch.einsum("etf,efh->eth", h, w_out_local)
    combined = torch.einsum("eth,te->th", y_local,
                            local_mask * ge[:, None])
    y = ReduceFromGroup.apply(combined, group)
    return y.to(x.dtype), aux


def init_moe_params(generator, num_experts, hidden, ffn,
                    dtype=torch.float32, device=None):
    """(router_w, w_in, w_out) with switch-style scaled init, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    router_w = normal(hidden, num_experts) * 0.02
    w_in = normal(num_experts, hidden, ffn) * (2.0 / hidden) ** 0.5
    w_out = normal(num_experts, ffn, hidden) * (2.0 / ffn) ** 0.5
    return router_w, w_in, w_out

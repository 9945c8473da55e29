"""Parallelism layer: meshes, shardings, and collective patterns — the
port of ``tensorflowonspark_tpu/parallel``.

The reference's parallelism surface is data-parallelism only (async-PS and
sync-allreduce, SURVEY.md §2.3), delegated to ``tf.distribute`` + NCCL.
The JAX package expresses the whole family through a
``jax.sharding.Mesh`` plus named shardings and ``shard_map``; the port
says the same in PyTorch's SPMD idiom: one process per card, a
``DeviceMesh`` over the ranks (:mod:`.mesh`), each rank holding its
local shards (DTensor placements for parameters, :mod:`.sharding`), and
the collectives written out (:mod:`.ring_attention`, :mod:`.moe`,
:mod:`.pipeline`). ``compat.shard_map`` has no counterpart.

Import discipline: importing this package starts no process group and
touches no card; the submodules below are imported by their users.
"""

from tensorflowonspark_tpu_torch.parallel.mesh import (  # noqa: F401
    build_hybrid_mesh,
    build_mesh,
    data_parallel_sharding,
    replicated_sharding,
)

__all__ = [
    "build_hybrid_mesh", "build_mesh", "data_parallel_sharding",
    "replicated_sharding",
    # submodules (imported lazily by users; listed for discoverability):
    # .sharding   — TP rule catalogs (BERT/ResNet/WideDeep/decoder) +
    #               appliers
    # .ring_attention — ring_attention / ring_flash_attention (SP)
    # .pipeline   — GPipe microbatch pipeline_apply (PP)
    # .moe        — expert-parallel moe_ffn (EP)
]

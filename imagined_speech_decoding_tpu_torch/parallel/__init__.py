"""Multi-rank training on ``torch.distributed``: meshes of ranks and the
collectives the ops and the engine use (``mesh``), the shard_map-style
data-parallel step (``dp``) and the multi-rank dry run (``dryrun``). Only
``mesh`` is imported here: the ops and models layers import its
collectives, and ``dp`` imports the train layer."""

from .mesh import (  # noqa: F401
    Mesh,
    StackShard,
    init_world,
    make_mesh,
    mesh_strategy,
    replicate,
    shard_leading_axis,
    shard_model_stack,
)

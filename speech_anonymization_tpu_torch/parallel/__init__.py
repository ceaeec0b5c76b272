"""Multi-process training on ``torch.distributed``: the launch, rank-0 gating
and batch-global collectives (``mesh``). The ASR's tensor-parallel rules are
imported from ``parallel.sharding_rules`` itself, as in the JAX package, so
that the ops and models that reduce over a mesh load ``mesh`` alone."""

from .mesh import (
    Mesh,
    all_gather_concat,
    all_gather_objects,
    all_gather_rows,
    data_parallel_grads,
    data_sharding,
    global_barrier,
    initialize_distributed,
    is_main_process,
    local_rows,
    make_mesh,
    pmax,
    psum,
    psum_grads,
    psum_terms,
    replicated_sharding,
    run_on_main,
    shard_batch,
    shutdown_distributed,
    use_mesh,
    world_size,
)

__all__ = [
    "Mesh",
    "all_gather_concat",
    "all_gather_objects",
    "all_gather_rows",
    "data_parallel_grads",
    "data_sharding",
    "global_barrier",
    "initialize_distributed",
    "is_main_process",
    "local_rows",
    "make_mesh",
    "pmax",
    "psum",
    "psum_grads",
    "psum_terms",
    "replicated_sharding",
    "run_on_main",
    "shard_batch",
    "shutdown_distributed",
    "use_mesh",
    "world_size",
]

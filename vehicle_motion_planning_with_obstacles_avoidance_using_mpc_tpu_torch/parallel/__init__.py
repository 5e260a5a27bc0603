"""Scenario-axis data parallelism over devices (the JAX package's
``parallel``): a mesh is a list of devices, each running its chunk of the
worlds."""

from .mesh import (
    init_distributed,
    make_mesh,
    shard_along,
    sharded_batch_solver,
    sharded_rollout,
    sharded_rollout_from,
)

__all__ = ["init_distributed", "make_mesh", "shard_along", "sharded_batch_solver",
           "sharded_rollout", "sharded_rollout_from"]

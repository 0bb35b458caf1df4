"""Data and tensor parallelism of the port, and its train and render steps
(the JAX package's parallel/).

The JAX package's make_mesh, shard_batch and replicate are JAX sharding
idioms with no one function here; the port does each job so:
  make_mesh     parallel/mesh.init_mesh (a process a rank, its data and
                model process groups: mesh.Mesh);
  shard_batch   Mesh.block (the rows of a global batch this rank takes);
  replicate     Mesh.broadcast (a tensor from one rank to every rank;
                Mesh.broadcast_module for a module's parameters).
"""

from .train_step import (TrainState, create_train_state, make_train_step,
                         make_render_step, TrainGates)

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "make_render_step", "TrainGates"]

"""Random minibatch sampling over the flat ray store (counterpart of the JAX
package's data/batcher.py).

  RayBatcher        - host NumPy gather; the caller copies each batch to the
                      device.
  DeviceRayBatcher  - the store lives in device memory; each step uploads
                      only the (batch,) int32 index vector, and the gather
                      runs on the device.
  ShardedRayBatcher - data parallelism: the store is sharded over the
                      ranks (each rank keeps 1/D of the rays on its
                      device), and each rank draws batch/D rays a step from
                      its own shard, without replacement within a local
                      epoch.

RayBatcher and DeviceRayBatcher keep this package's own copy of the JAX
package's shuffled-epoch logic on numpy's default_rng, so for one seed both
packages draw identical index sequences.  On a mesh (parallel/mesh.Mesh)
every rank draws that same global sequence and takes its contiguous block
of each batch (the JAX package's shard_batch of the global batch);
ShardedRayBatcher draws the JAX package's per-shard sequence, all shards'
permutations from one generator, so every rank knows every shard's draw.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class RayBatcher:
    """Shuffled-epoch batcher over a dict of equally-sized (N, ...) arrays
    (host gather).  With a mesh, next_batch gives this rank's block of the
    global batch."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, mesh=None):
        self.mesh = mesh
        if mesh is not None and batch_size % mesh.n_data:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"the {mesh.n_data} data ranks of the mesh")
        self.arrays = arrays
        n = {k: v.shape[0] for k, v in arrays.items()}
        sizes = set(n.values())
        assert len(sizes) == 1, f"ragged ray store: {n}"
        self.n = sizes.pop()
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._perm = self.rng.permutation(self.n)
        self._pos = 0

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.n // self.batch_size)

    def next_indices(self) -> np.ndarray:
        if self._pos + self.batch_size > self.n:
            self._perm = self.rng.permutation(self.n)
            self._pos = 0
        idx = self._perm[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return idx

    def next_local_indices(self) -> np.ndarray:
        """The next batch's indices this rank gathers: its block of the
        global batch on a mesh, the whole batch without one."""
        idx = self.next_indices()
        if self.mesh is not None:
            idx = idx[self.mesh.block(len(idx))]
        return idx

    def next_batch(self) -> Dict[str, np.ndarray]:
        idx = self.next_local_indices()
        return {k: v[idx] for k, v in self.arrays.items()}


class DeviceRayBatcher(RayBatcher):
    """Device-resident store plus an on-device gather per step.  The host
    copy is dropped once the store is on the device.  With a mesh, each
    rank holds the whole store on its device (mesh.device) and gathers its
    block of each batch."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, device=None, mesh=None):
        from ..utils.device import resolve_device
        super().__init__(arrays, batch_size, seed, mesh)
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self._store = {k: torch.as_tensor(np.ascontiguousarray(v),
                                          device=self.device)
                       for k, v in arrays.items()}
        self.arrays = {}

    @property
    def store(self) -> Dict[str, torch.Tensor]:
        """The device-resident arrays, for the train step's own gather."""
        return self._store

    def next_index_tensor(self) -> torch.Tensor:
        """The next (batch,) int32 index vector (on a mesh, this rank's
        block of it), on the device."""
        idx = self.next_local_indices().astype(np.int32)
        return torch.from_numpy(idx).to(self.device, non_blocking=True)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        idx = self.next_index_tensor()
        return {k: torch.index_select(v, 0, idx)
                for k, v in self._store.items()}


class ShardedRayBatcher:
    """The store sharded over the mesh's D ranks, with per-shard index
    draws (the JAX package's ShardedRayBatcher, data/batcher.py:110-207).

    The store is padded to a multiple of D by wrapping (rows 0..pad-1
    appended, pad < D), so the duplicated rays are drawn at most once more
    a local epoch, and never when N % D == 0.  Shard d holds padded rows
    [d * shard_size, (d + 1) * shard_size); with place, this rank keeps
    only its own shard, on its device (mesh.device).

    next_indices() returns every shard's LOCAL indices as D contiguous
    blocks of batch/D, all shards' permutations drawn from one generator
    (so every rank draws the same sequence); next_index_tensor() uploads
    this rank's block, which indexes its shard.  global_indices(local)
    converts a draw to indices into the padded global store, for a
    replicated run that replays the same draws.  `mesh` needs a
    .shape[axis] shard count (and with place, .data_rank and .device:
    the ranks of a model group hold the same shard)."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 mesh, seed: int = 0, axis: str = "data",
                 place: bool = True):
        n = {k: v.shape[0] for k, v in arrays.items()}
        sizes = set(n.values())
        assert len(sizes) == 1, f"ragged ray store: {n}"
        self.n = sizes.pop()
        d = int(mesh.shape[axis])
        if batch_size % d:
            raise ValueError(
                f"batch_size {batch_size} not divisible by the {d}-device "
                f"'{axis}' mesh axis")
        self.mesh = mesh
        self.n_shards = d
        self.local_batch = batch_size // d
        self.batch_size = batch_size
        self.shard_size = -(-self.n // d)          # ceil
        if self.n < d:
            # wrap-padding appends rows 0..pad-1 once, so it can fill up
            # to 2n rows only: a store smaller than the mesh comes out
            # ragged
            raise ValueError(
                f"ray store has {self.n} rays but the '{axis}' mesh axis "
                f"has {d} shards; need at least one ray per shard")
        if self.local_batch > self.shard_size:
            raise ValueError(
                f"per-shard batch {self.local_batch} (batch_size "
                f"{batch_size} / {d} shards) exceeds the per-shard store "
                f"size {self.shard_size} (store {self.n} rays); shrink "
                f"batch_size or grow the store")
        self._store: Dict[str, torch.Tensor] = {}
        self.device = None
        if place:
            self.device = torch.device(mesh.device)
            d = mesh.data_rank
            rows = slice(d * self.shard_size, (d + 1) * self.shard_size)
            for k, v in self.padded_arrays(arrays).items():
                self._store[k] = torch.as_tensor(
                    np.ascontiguousarray(v[rows]), device=self.device)
        self.rng = np.random.default_rng(seed)
        self._perms = self._new_perms()
        self._pos = 0

    def _new_perms(self) -> np.ndarray:
        return np.stack([self.rng.permutation(self.shard_size)
                         for _ in range(self.n_shards)])

    @property
    def store(self) -> Dict[str, torch.Tensor]:
        """This rank's shard, on its device."""
        return self._store

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.shard_size // self.local_batch)

    def next_indices(self) -> np.ndarray:
        if self._pos + self.local_batch > self.shard_size:
            self._perms = self._new_perms()
            self._pos = 0
        out = self._perms[:, self._pos:self._pos + self.local_batch]
        self._pos += self.local_batch
        return np.ascontiguousarray(out.reshape(-1)).astype(np.int32)

    def next_local_indices(self) -> np.ndarray:
        """This rank's block of the next draw: local indices into its
        shard."""
        return np.ascontiguousarray(
            self.next_indices()[self.mesh.block(self.batch_size)])

    def next_index_tensor(self) -> torch.Tensor:
        """next_local_indices, on this rank's device."""
        return torch.from_numpy(self.next_local_indices()).to(
            self.device, non_blocking=True)

    def global_indices(self, local: np.ndarray) -> np.ndarray:
        """Local per-shard draw -> indices into the PADDED global store
        (shard d's rows live at [d*shard_size, (d+1)*shard_size))."""
        blocks = local.reshape(self.n_shards, -1).astype(np.int64)
        offs = np.arange(self.n_shards, dtype=np.int64)[:, None]
        return (blocks + offs * self.shard_size).reshape(-1)

    def padded_arrays(self, arrays: Dict[str, np.ndarray]) -> Dict:
        """The host-side padded twin of the sharded store."""
        pad = self.shard_size * self.n_shards - self.n
        if not pad:
            return dict(arrays)
        return {k: np.concatenate([v, v[:pad]], axis=0)
                for k, v in arrays.items()}

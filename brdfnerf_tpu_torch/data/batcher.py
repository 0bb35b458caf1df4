"""Random minibatch sampling over the flat ray store (counterpart of the JAX
package's data/batcher.py; ShardedRayBatcher is not ported yet).

  RayBatcher        - host NumPy gather; the caller copies each batch to the
                      device.
  DeviceRayBatcher  - the store lives in device memory; each step uploads
                      only the (batch,) int32 index vector, and the gather
                      runs on the device.

Both keep this package's own copy of the JAX package's shuffled-epoch
logic on numpy's default_rng, so for one seed both packages draw identical
index sequences.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class RayBatcher:
    """Shuffled-epoch batcher over a dict of equally-sized (N, ...) arrays
    (host gather)."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0):
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

    def next_batch(self) -> Dict[str, np.ndarray]:
        idx = self.next_indices()
        return {k: v[idx] for k, v in self.arrays.items()}


class DeviceRayBatcher(RayBatcher):
    """Device-resident store plus an on-device gather per step.  The host
    copy is dropped once the store is on the device."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, device=None):
        from ..utils.device import resolve_device
        super().__init__(arrays, batch_size, seed)
        self.device = resolve_device(device)
        self._store = {k: torch.as_tensor(np.ascontiguousarray(v),
                                          device=self.device)
                       for k, v in arrays.items()}
        self.arrays = {}

    @property
    def store(self) -> Dict[str, torch.Tensor]:
        """The device-resident arrays, for the train step's own gather."""
        return self._store

    def next_index_tensor(self) -> torch.Tensor:
        """The next (batch,) int32 index vector, on the device."""
        idx = self.next_indices().astype(np.int32)
        return torch.from_numpy(idx).to(self.device, non_blocking=True)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        idx = self.next_index_tensor()
        return {k: torch.index_select(v, 0, idx)
                for k, v in self._store.items()}

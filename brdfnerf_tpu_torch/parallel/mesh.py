"""Data parallelism over GPUs (counterpart of the JAX package's
parallel/mesh.py).

The JAX package runs one SPMD program over a 1-D 'data' mesh: rays shard
along the batch axis, parameters replicate, and XLA inserts the gradient
all-reduce.  Here training runs one process per GPU under torch.distributed
(NCCL on CUDA, gloo on the CPU): each rank holds a replica of the
parameters and the optimizer state, takes its contiguous block of every
global batch, and all-reduces the gradients before the optimizer step
(parallel/train_step.py).  One Python thread launching for N cards would
not scale: the single-card step is already bound by its host.

`Mesh` names one rank's process group: its rank, the world size, its
device and backend, with the few collectives the step needs.  `init_mesh`
joins the group through a torch.distributed FileStore (a file the ranks
share, so no port is chosen); `run_ranks` starts ranks 1..N-1 as spawned
processes and runs rank 0 in the calling process.  The backend follows
the device unless the caller names one; nothing switches NCCL to gloo on
its own.  Two ranks on one card need gloo: NCCL refuses two ranks on one
device.

Tensor parallelism (parallel/tensor.py) makes the mesh 2-D: `n_model`
ranks a model group, rank = d * n_model + m with 'model' innermost (the
JAX package's tp_mesh), a process group a data column and a model row.
The batch splits over the data axis alone (`block`), so every rank of a
model group takes the same rows and draws; the gradients, the losses'
global counts and the metrics reduce over the data group, and the trunk's
collectives run over the model group.  A mesh of n_model 1 is the 1-D
data-parallel mesh, its data group the world.

Serving is one process with a replica on each of the first N devices
(`serving_devices`; parallel/train_step.render_blocks).
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
import time
import uuid
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# a rank that waits for another (rank 0 validating, say) waits this long
TIMEOUT = datetime.timedelta(minutes=60)
# rank 0, blocked after another rank failed, ends this many seconds on
GRACE = 30.0


class Mesh:
    """One rank of a (data, model) mesh of `size` ranks, n_model of them a
    model group (1: the 1-D data-parallel mesh).  The n_data = size /
    n_model data ranks each hold an equal, contiguous block of every
    global batch (`block`); sum, max and reduce_grads reduce over this
    rank's data group (the ranks of its model rank), broadcast and
    barrier over the world, model_all_reduce_ and model_all_gather over
    its model group.  With a gloo group on CUDA tensors the collectives
    stage through the host."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, store_path: Optional[str] = None,
                 n_model: int = 1, data_group=None, model_group=None):
        self.rank = int(rank)
        self.size = int(size)
        self.n_model = int(n_model)
        self.n_data = self.size // self.n_model
        self.data_rank, self.model_rank = divmod(self.rank, self.n_model)
        self.device = torch.device(device)
        self.backend = backend
        self.store_path = store_path
        # None: the default group (the world), which a 1-D mesh's data
        # group is
        self.data_group = data_group
        self.model_group = model_group
        # the model group's collectives so far: calls, bytes this rank
        # sent in, seconds (host clock; with gloo on CUDA tensors, the
        # staging copies included)
        self.model_calls = self.model_bytes = 0
        self.model_seconds = 0.0

    @property
    def shape(self):
        """The mesh's axes, as the JAX package's Mesh.shape reads."""
        return {"data": self.n_data, "model": self.n_model}

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a global batch of n rows: its
        data rank's (the ranks of a model group take the same block)."""
        if n % self.n_data:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.n_data} data ranks")
        per = n // self.n_data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def _staged(self, t: torch.Tensor, fn) -> torch.Tensor:
        if self.backend == "gloo" and t.device.type != "cpu":
            host = t.cpu()
            fn(host)
            t.copy_(host)
        else:
            fn(t)
        return t

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """t reduced over the data group, in place."""
        return self._staged(t, lambda x: dist.all_reduce(
            x, op=op, group=self.data_group))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of t summed over the data group."""
        return self.all_reduce_(t.detach().clone())

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of t's largest value over the data group."""
        return self.all_reduce_(t.detach().clone(), dist.ReduceOp.MAX)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """A copy of rank src's t on every rank."""
        return self._staged(t.detach().clone(),
                            lambda x: dist.broadcast(x, src))

    def _model_count(self, t: torch.Tensor, t0: float) -> None:
        self.model_calls += 1
        self.model_bytes += t.numel() * t.element_size()
        self.model_seconds += time.perf_counter() - t0

    def model_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the model group, in place."""
        t0 = time.perf_counter()
        self._staged(t, lambda x: dist.all_reduce(x, group=self.model_group))
        self._model_count(t, t0)
        return t

    def model_all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every model rank's t (of one shape), in model-rank order."""
        t0 = time.perf_counter()
        t = t.contiguous()
        host = t.cpu() if (self.backend == "gloo"
                           and t.device.type != "cpu") else t
        parts = [torch.empty_like(host) for _ in range(self.n_model)]
        dist.all_gather(parts, host, group=self.model_group)
        parts = [p.to(t.device) for p in parts]
        self._model_count(t, t0)
        return parts

    def reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum the parameters' gradients over the data group, in one flat
        buffer; a parameter without a gradient takes zeros (as the
        optimizer's step gives it).  Under tensor parallelism a trunk
        block's gradient is its model rank's alone, and a replicated
        parameter's is the same on every rank of a model group, so the
        data group is the whole sum."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def broadcast_module(self, module: torch.nn.Module, src: int = 0):
        """Every parameter of `module` set to rank src's values (whole
        parameters: under tensor parallelism, before the blocks are
        cut)."""
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(self.broadcast(p, src))

    def barrier(self):
        self._staged(torch.zeros(1, device=self.device), dist.all_reduce)

    def close(self):
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.rank == 0 and self.store_path:
            try:
                os.remove(self.store_path)
            except FileNotFoundError:
                pass


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: int) -> torch.device:
    """Rank `rank`'s device: cuda:<rank> for CUDA, the CPU otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank)
    return device


def check_devices(n_devices: int, device) -> None:
    """Refuse n_devices above the visible CUDA devices (on the CPU any
    number of ranks share it)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(
            f"n_devices={n_devices} but only {torch.cuda.device_count()} "
            f"CUDA device(s) visible: a silently smaller mesh would run at "
            f"a fraction of the expected rate")


def new_store_path(directory: str) -> str:
    """A fresh rendezvous file in `directory` (created)."""
    os.makedirs(directory, exist_ok=True)
    return os.path.join(os.path.abspath(directory),
                        f".rendezvous-{uuid.uuid4().hex}")


def init_mesh(rank: int, size: int, store_path: str, device,
              backend: Optional[str] = None, n_model: int = 1) -> Mesh:
    """Join the process group of `size` ranks as `rank` through the
    FileStore at store_path.  device: the rank's device (cuda:<k> or the
    CPU); backend: NCCL on CUDA, gloo on the CPU unless named.  n_model > 1
    makes the mesh (size / n_model, n_model): every rank creates every
    data and model group, in the same order."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if n_model < 1 or size % n_model:
        raise ValueError(f"a model axis of {n_model} does not split "
                         f"{size} ranks")
    store = dist.FileStore(store_path, size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size, timeout=TIMEOUT)
    groups = {}
    if n_model > 1:
        n_data = size // n_model
        d, m = divmod(rank, n_model)
        for col in range(n_model):
            g = dist.new_group([r * n_model + col for r in range(n_data)])
            if col == m:
                groups["data_group"] = g
        for row in range(n_data):
            g = dist.new_group([row * n_model + c for c in range(n_model)])
            if row == d:
                groups["model_group"] = g
    return Mesh(rank, size, device, backend, store_path, n_model, **groups)


def _rank_entry(index: int, fn: Callable, size: int, store_path: str,
                devices: List[str], backend: Optional[str], threads: int,
                args: tuple, n_model: int = 1):
    """The body of a spawned rank (rank index + 1)."""
    torch.set_num_threads(threads)
    rank = index + 1
    mesh = init_mesh(rank, size, store_path, devices[rank], backend,
                     n_model)
    try:
        fn(mesh, *args)
    finally:
        mesh.close()


def _rank_of(e) -> str:
    """The rank a spawned process's error names (torch counts the spawned
    processes from 0; they are ranks 1..N-1)."""
    return f"rank {getattr(e, 'error_index', -1) + 1}"


def _watch(ctx, done, failed: list):
    """Rank 0's watch over the spawned ranks (a thread): once one exits
    with an error, the others are stopped and its error kept in `failed`;
    should rank 0 still be blocked GRACE seconds later (in the rendezvous,
    or in a collective that NCCL does not break off), the error is
    printed and the process ends."""
    try:
        while not done.is_set() and not ctx.join(timeout=0.5):
            pass
    except Exception as e:
        failed.append(e)
        if not done.wait(GRACE):
            print(f"rank 0 is still blocked {GRACE:.0f} s after "
                  f"{_rank_of(e)} failed:{e}", file=sys.stderr, flush=True)
            os._exit(1)


def run_ranks(fn: Callable, size: int, store_dir: str, device,
              backend: Optional[str] = None, args: tuple = (),
              devices: Optional[Sequence] = None, n_model: int = 1):
    """fn(mesh, *args) on `size` ranks (a (size / n_model, n_model) mesh
    with n_model > 1): ranks 1..size-1 in spawned
    processes, rank 0 in this one; returns rank 0's result.  Rank k runs
    on devices[k] (default rank_device(device, k): cuda:<k>, or the CPU);
    two ranks that share a card need backend='gloo'.  A failure of
    rank 0 stops the others.  A failure of another rank stops the rest
    and raises here with that rank's traceback (as a note to rank 0's
    error where rank 0 fails with it: a gloo collective breaks off at
    once), or, should rank 0 stay blocked, ends the process GRACE
    seconds on (_watch).  fn and args must pickle, and the
    spawned ranks import this package only."""
    import torch.multiprocessing as mp
    device = torch.device(device)
    devices = [str(d) for d in (devices or [rank_device(device, k)
                                            for k in range(size)])]
    store_path = new_store_path(store_dir)
    ctx = watcher = None
    done, failed = threading.Event(), []
    if size > 1:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, size, store_path, devices, backend,
                               torch.get_num_threads(), args, n_model),
            nprocs=size - 1, join=False, start_method="spawn")
        watcher = threading.Thread(target=_watch, args=(ctx, done, failed),
                                   daemon=True)
        watcher.start()

    def stop_watch():
        done.set()
        if watcher is not None:
            watcher.join()

    try:
        mesh = init_mesh(0, size, store_path, devices[0], backend, n_model)
        try:
            out = fn(mesh, *args)
        finally:
            mesh.close()
    except BaseException as e:
        stop_watch()
        if ctx is not None:
            if not failed:
                try:    # a rank that fails with rank 0 (a lost peer)
                    ctx.join(timeout=5)
                except Exception as other:
                    failed.append(other)
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join()
        if failed:
            e.add_note(f"{_rank_of(failed[0])} failed:{failed[0]}")
        raise
    stop_watch()
    if failed:
        failed[0].add_note(f"(that is {_rank_of(failed[0])})")
        raise failed[0]
    if ctx is not None:
        while not ctx.join():
            pass
    return out


def serving_devices(n_devices: int, device) -> List[torch.device]:
    """The devices of an n_devices-replica server: the first n_devices
    CUDA devices (refused above the visible count), or n_devices replicas
    on the CPU."""
    device = torch.device(device)
    n = max(1, int(n_devices))
    if device.type != "cuda":
        return [device] * n
    check_devices(n, device)
    return [torch.device("cuda", i) for i in range(n)]

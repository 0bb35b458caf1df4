"""One tensor-parallel train step held against the one-device step.

    python3 -m brdfnerf_tpu_torch.tools.tp_check [--data 1] [--model 2]
        [--backend gloo] [--dtype float32] [--feat 2048] [--layers 12]
        [--batch 64] [--device cuda]

The same whole weights, ray store, global index vector and step seed go
through parallel/train_step.make_fused_train_step on one device (the
unfused trunk: K1-K5 off) and on a (data, model) mesh of data * model
ranks (parallel/mesh.run_ranks; tools/dp_check.run_steps cuts each
rank's blocks and gathers the results whole).  By default the
configuration is the one tensor parallelism exists for: the flagship
stage-2 step (RPV(111), analytic normals and their losses, the sun march)
on a 12 x 2048 trunk, skip 4 (tools/dp_check.flagship_payload).  Ranks
that share a card need gloo (NCCL refuses two ranks on one device).

Printed: the loss of each, the worst gradient difference over its
gradient's largest magnitude, the worst parameter difference past its
bound, and each rank's trunk bytes against the one device's; the exit
code is 1 where a bound is missed (`compare`, the JAX package's TP
bounds, tests/test_tensor_parallel.py), a rank holds other than its
share of the trunk (1/model of every weight and of the column layers'
biases; the row layers' biases are whole), or either run launched one
of K1-K5.  Rank 0's model-group collectives (calls, bytes, seconds on the
host's clock) are printed beside.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

# the JAX package's bounds for a TP step against one device
# (tests/test_tensor_parallel.py: loss rtol 2e-4; weights rtol 2e-4,
# atol 2e-6), each gradient held to GRAD_RTOL of its largest magnitude
LOSS_RTOL = 2e-4
PARAM_RTOL = 2e-4
PARAM_ATOL = 2e-6
GRAD_RTOL = 2e-4
# a gradient element near zero takes its sign from the order of its sums,
# and Adam's first step turns either sign into a step of about lr: at most
# this share of a tensor's elements may miss the parameter bound, by at
# most 2 * lr (tests/torch_port_common.three_fused_steps_match's rule)
FLIP_SHARE = 1e-3


def compare(one: Dict, many: Dict, lr: float) -> Dict:
    """The last loss, every gradient and every parameter of two
    tools/dp_check.run_steps results (one device, the mesh) against the
    bounds: the loss's relative difference, each gradient's largest
    difference over its largest magnitude, and each parameter's share of
    elements past PARAM_ATOL + PARAM_RTOL * |ref| with the largest
    difference among them."""
    la, lb = one["loss"][-1], many["loss"][-1]
    loss_rel = abs(la - lb) / max(abs(la), 1e-30)
    grad_rel = {}
    for k, g in one["grads"].items():
        scale = float(np.abs(g).max())
        grad_rel[k] = float(np.abs(many["grads"][k] - g).max()) / max(
            scale, 1e-30)
    params = {}
    for k, ref in one["params"].items():
        d = np.abs(many["params"][k] - ref)
        past = d > PARAM_ATOL + PARAM_RTOL * np.abs(ref)
        params[k] = (float(past.mean()), float(d.max()))
    held = (loss_rel <= LOSS_RTOL
            and max(grad_rel.values()) <= GRAD_RTOL
            and all(share <= FLIP_SHARE and (share == 0 or dmax <= 2 * lr)
                    for share, dmax in params.values()))
    return {"loss": (la, lb), "loss_rel": loss_rel, "grad_rel": grad_rel,
            "worst_grad": max(grad_rel.items(), key=lambda kv: kv[1]),
            "params": params,
            "worst_param": max(params.items(), key=lambda kv: kv[1]),
            "held": bool(held)}


def normals(mesh, payload: Dict, device=None) -> Dict:
    """The analytic normals (-normalize(grad_x sigma), models/network.
    analytic_normals) of payload["xyz"] and the gradients of a loss of
    them (the sum of normals * payload["cot"]: the double backward
    through the trunk), on mesh (each rank its blocks, the gradients
    gathered whole) or with mesh None on `device` alone.  payload: the
    model config "mcfg" and the whole weights "flat" (npz layout)."""
    from ..models.network import analytic_normals
    from ..parallel import tensor
    from ..utils.checkpoint import params_from_flat
    dev = torch.device(mesh.device if mesh is not None else device)
    mcfg = payload["mcfg"]
    params = params_from_flat(payload["flat"], mcfg, device=dev)
    layout = tensor.state_shardings(mesh, mcfg.skips)
    if layout is not None:
        tensor.shard_params(params, layout)
    xyz = torch.as_tensor(payload["xyz"], device=dev)
    with torch.enable_grad():
        n = analytic_normals(params.coarse, mcfg, xyz)
        (n * torch.as_tensor(payload["cot"], device=dev)).sum().backward()
    grads = {}
    for k, p in params.named_parameters():
        if p.grad is None:          # the heads past sigma's
            continue
        g = p.grad.detach()
        if layout is not None:
            g = tensor.gather_tensor(k.replace(".", "/"), g, layout)
        grads[k] = g.cpu().numpy()
    return {"normals": n.detach().cpu().numpy(), "grads": grads}


# every trunk kernel's launch counter (ops/cuda_build.CudaKernel): the
# fused family's K1-K5 and the layer-major family's K1-K3
KERNELS = {"K1": ("fused_mlp", "TRUNK_SIGMA"),
           "K2": ("fused_trunk_vjp", "TRUNK_FWD_GRAD"),
           "K3": ("fused_trunk_vjp", "TRUNK_BWD"),
           "K4": ("fused_trunk_heads", "TRUNK_HEADS_FWD"),
           "K5": ("fused_trunk_heads", "TRUNK_HEADS_BWD"),
           "K1 layer-major": ("trunk_layers", "TRUNK_SIGMA_WIDE"),
           "K2 layer-major": ("trunk_layers", "TRUNK_FWD_GRAD_WIDE"),
           "K3 layer-major": ("trunk_layers", "TRUNK_BWD_WIDE")}


def kernel_launches() -> Dict[str, int]:
    """Every trunk kernel's launch count in this process (KERNELS)."""
    import importlib
    return {k: getattr(importlib.import_module(
        f"brdfnerf_tpu_torch.ops.{mod}"), name).launches
        for k, (mod, name) in KERNELS.items()}


def render(mesh, payload: Dict, device=None) -> Dict:
    """parallel/train_step.make_render_step (on mesh: every rank of the
    model group renders the same rays with its blocks, K1-K5 off) of
    payload["rays"] on the whole weights "flat" with render config
    "rcfg" and the draws chunk_draws(seed 0) gives; the numpy outputs."""
    from ..parallel import tensor
    from ..parallel.train_step import make_render_step
    from ..render.render import RenderInputs, chunk_draws
    from ..utils.checkpoint import params_from_flat
    dev = torch.device(mesh.device if mesh is not None else device)
    mcfg, rcfg = payload["mcfg"], payload["rcfg"]
    params = params_from_flat(payload["flat"], mcfg, device=dev)
    layout = tensor.state_shardings(mesh, mcfg.skips)
    if layout is not None:
        tensor.shard_params(params, layout)
    rays = torch.as_tensor(payload["rays"], device=dev)
    n = rays.shape[0]
    res = make_render_step(mcfg, rcfg, mesh=mesh)(
        params, RenderInputs(rays=rays, ts=torch.zeros(
            n, dtype=torch.int64, device=dev)),
        draws=chunk_draws(mcfg, rcfg, n, dev))
    return {k: v.float().cpu().numpy() for k, v in res.items()
            if torch.is_tensor(v)}


def _rank_jobs(mesh, jobs):
    from .dp_check import run_steps
    fns = {"steps": run_steps, "normals": normals, "render": render}
    before = kernel_launches()
    results = [fns[kind](mesh, payload) for kind, payload in jobs]
    # the jobs' launches, summed over the ranks (NCCL reduces on the card)
    got = torch.tensor([v - before[k] for k, v in kernel_launches().items()],
                       dtype=torch.float64,
                       device="cpu" if mesh.backend == "gloo" else mesh.device)
    torch.distributed.all_reduce(got)
    return {"results": results,
            "launches": dict(zip(KERNELS, map(int, got.tolist()))),
            "collectives": {"calls": mesh.model_calls,
                            "bytes": mesh.model_bytes,
                            "seconds": mesh.model_seconds}}


def on_mesh(jobs, n_data: int, n_model: int, device, backend=None,
            devices=None, store_dir=None) -> Dict:
    """[(kind, payload)] jobs ("steps": tools/dp_check.run_steps,
    "normals": normals, "render": render) on one (n_data, n_model) mesh
    of ranks: rank 0's
    "results", in order, the jobs' K1-K5 "launches" summed over the ranks
    and rank 0's model-group "collectives" (calls, bytes, seconds)."""
    import tempfile
    from ..parallel.mesh import run_ranks
    with tempfile.TemporaryDirectory(dir=store_dir) as td:
        return run_ranks(_rank_jobs, n_data * n_model, td, device,
                         backend=backend, args=(jobs,), devices=devices,
                         n_model=n_model)


def share_bytes(flat: Dict[str, np.ndarray], n_model: int,
                skips) -> int:
    """The trunk bytes a rank of an n_model model axis holds under the
    layout's rule (parallel/tensor.cut_axis): 1/n_model of every weight
    and of the column layers' biases, the row layers' biases whole."""
    from ..parallel.tensor import cut_axis
    return sum(v.nbytes // (n_model if cut_axis(k, skips) is not None
                            else 1)
               for k, v in flat.items() if "/fc_net/" in k)


def run(n_data: int = 1, n_model: int = 2, dtype: str = "float32",
        feat: int = 2048, layers: int = 12, batch: int = 64,
        device="cuda", backend=None, devices=None, store_dir=None,
        seed: int = 0) -> Dict:
    """One step of flagship_payload(dtype, feat, batch, layers, kernels
    off) on one device and on the (n_data, n_model) mesh; compare's
    result with both runs' seconds and trunk bytes."""
    import time
    from .dp_check import flagship_payload, run_steps
    p = flagship_payload(dtype, feat, batch, seed, layers=layers,
                         kernels=False)
    before = kernel_launches()
    t0 = time.perf_counter()
    one = run_steps(None, p, device=device)
    t_one = time.perf_counter() - t0
    launches_one = {k: v - before[k] for k, v in kernel_launches().items()}
    t0 = time.perf_counter()
    got = on_mesh([("steps", p)], n_data, n_model, device, backend=backend,
                  devices=devices, store_dir=store_dir)
    t_many = time.perf_counter() - t0
    many = got["results"][0]
    out = compare(one, many, p["tcfg"].lr)
    out.update(seconds_one=t_one, seconds_mesh=t_many,
               launches_one=launches_one, launches_mesh=got["launches"],
               collectives=got["collectives"],
               trunk_bytes_one=one["trunk_bytes"],
               trunk_bytes_rank=many["trunk_bytes"],
               trunk_bytes_share=share_bytes(one["params"], n_model,
                                             p["mcfg"].skips))
    out["bytes_held"] = out["trunk_bytes_rank"] == out["trunk_bytes_share"]
    out["no_kernels"] = not any(launches_one.values()) and not any(
        got["launches"].values())
    out["held"] = bool(out["held"] and out["bytes_held"]
                       and out["no_kernels"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", type=int, default=1)
    p.add_argument("--model", type=int, default=2)
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: the device's; ranks that "
                        "share one card need gloo)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--feat", type=int, default=2048)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    ranks = args.data * args.model
    devices = None
    if dev.type == "cuda" and torch.cuda.device_count() < ranks:
        devices = ["cuda:0"] * ranks
    c = run(args.data, args.model, args.dtype, args.feat, args.layers,
            args.batch, dev, args.backend, devices)
    print(json.dumps({k: c[k] for k in (
        "loss", "loss_rel", "worst_grad", "worst_param", "trunk_bytes_one",
        "trunk_bytes_rank", "trunk_bytes_share", "seconds_one",
        "seconds_mesh", "launches_one", "launches_mesh", "collectives",
        "held")}))
    return 0 if c["held"] else 1


if __name__ == "__main__":
    sys.exit(main())

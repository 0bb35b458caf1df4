"""One data-parallel train step held against the one-device step.

    python3 -m brdfnerf_tpu_torch.tools.dp_check [--ranks 2]
        [--backend gloo] [--dtype float32] [--feat 512] [--batch 1024]
        [--device cuda]

The same weights, ray store, index vector and step seed go through
parallel/train_step.make_fused_train_step on one device and on `ranks`
ranks (parallel/mesh.run_ranks: one process a rank; ranks that share a
card need gloo, NCCL refuses two ranks on one device).  Printed: the
loss of each, and every gradient's largest difference over that
gradient's largest magnitude; the exit code is 1 where the loss differs
by more than 1e-5 of itself (and of 1) or a gradient by more than
atol 5e-6 + rtol 5e-5 of its scale (the JAX package's bounds,
tests/test_sharding.py:100-104).

The helpers (run_steps, on_ranks, compare) serve chip_smoke.py and the
CPU tests: a payload holds the configs, the weights (the npz layout), the
store and, per step, the global index vector and optionally the global
draws and the state to start from (parameters and Adam moments, as a
test carries the JAX package's state into each step).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

# the JAX package's bounds for a data-parallel step against one device
# (tests/test_sharding.py:100-104), each gradient's held to its scale
LOSS_TOL = 1e-5
GRAD_ATOL = 5e-6
GRAD_RTOL = 5e-5


def set_state(state, start: Dict, layout=None) -> None:
    """Set state's parameters and Adam moments to start's numpy flats
    ("p", and "mu", "nu" with "count" > 0; npz keys, (in, out) weights,
    whole: under a tensor-parallel layout each rank takes its blocks)."""
    from ..parallel.tensor import cut
    from ..utils.checkpoint import named_flat
    count = int(start.get("count", 0))
    with torch.no_grad():
        for key, p in named_flat(state.params).items():
            def get(tree):
                v = torch.as_tensor(np.asarray(start[tree][key]),
                                    device=p.device)
                v = v.t() if key.endswith("/w") else v
                if layout is not None:
                    v = cut(key, v, layout.n_model, layout.m, layout.skips)
                return v.contiguous()
            p.copy_(get("p"))
            if count and state.opt_state is not None:
                state.opt_state.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": get("mu"), "exp_avg_sq": get("nu")}


def run_steps(mesh, payload: Dict, device=None) -> Dict:
    """payload's steps through make_fused_train_step, on mesh (a rank's
    block of each global index vector, on mesh.device) or, with mesh None,
    on `device` alone.  With payload["sharded"], the store is sharded over
    the mesh (data/batcher.ShardedRayBatcher) and each index vector holds
    every shard's local indices (its D blocks).  Returns the losses and
    metrics of every step, the last step's gradients and the final
    parameters (numpy, npz keys), and with payload["record"] the
    parameters after every step ("params_each").  On a (data, model)
    mesh (parallel/tensor.py) each rank trains its blocks of the trunk,
    and the gradients and parameters come back gathered whole, with the
    bytes of the trunk's parameters this rank held ("trunk_bytes")."""
    from ..data.batcher import ShardedRayBatcher
    from ..parallel import tensor
    from ..parallel import train_step as ts
    from ..utils.checkpoint import params_to_flat
    dev = torch.device(mesh.device if mesh is not None else device)
    mcfg, rcfg, tcfg = payload["mcfg"], payload["rcfg"], payload["tcfg"]
    layout = tensor.state_shardings(mesh, mcfg.skips)
    state, opt = ts.create_train_state(
        mcfg, tcfg, payload.get("steps_per_epoch", 3), flat=payload["flat"],
        n_importance=rcfg.n_importance, device=dev, layout=layout)

    def whole_flat(params):
        if layout is not None:
            params = tensor.whole_params(params, layout)
        return _copied(params_to_flat(params))
    sharded = bool(payload.get("sharded"))
    step = ts.make_fused_train_step(mcfg, rcfg, tcfg, opt,
                                    ts.GateSchedule(**payload["sched"]),
                                    mesh=mesh, store_sharded=sharded)
    if sharded:
        store = ShardedRayBatcher(payload["store"], len(payload["idx"][0]),
                                  mesh).store
    else:
        store = {k: torch.as_tensor(v, device=dev)
                 for k, v in payload["store"].items()}
    out: Dict = {"loss": [], "metrics": [], "params_each": []}
    for i, idx in enumerate(payload["idx"]):
        start = (payload.get("states") or [None] * (i + 1))[i]
        if start is not None:
            set_state(state, start, layout)
            state = ts.TrainState(state.params, state.opt_state, i)
        if mesh is not None:
            idx = idx[mesh.block(len(idx))]
        draws = None
        if payload.get("draws") is not None:
            draws = {k: torch.as_tensor(v, device=dev)
                     for k, v in payload["draws"][i].items()}
        state, m = step(state, store,
                        torch.as_tensor(np.ascontiguousarray(idx),
                                        device=dev),
                        payload.get("seed", 0), draws=draws)
        out["loss"].append(float(m["loss"]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if payload.get("record"):
            out["params_each"].append(whole_flat(state.params))
    out["grads"] = {}
    for k, p in state.params.named_parameters():
        if p.grad is not None:
            g = p.grad.detach()
            if layout is not None:
                g = tensor.gather_tensor(k.replace(".", "/"), g, layout)
            out["grads"][k] = g.float().cpu().numpy()
    out["params"] = whole_flat(state.params)
    out["trunk_bytes"] = tensor.trunk_bytes(state.params)
    # {parameter: (its shape, its Adam moments' shapes)} on this rank
    out["shapes"] = {
        k: (tuple(p.shape), tuple(
            tuple(st[m].shape) for st in [state.opt_state.state.get(p, {})]
            for m in ("exp_avg", "exp_avg_sq") if m in st))
        for k, p in state.params.named_parameters()}
    return out


def _copied(flat: Dict) -> Dict:
    """A flat's arrays copied (params_to_flat's share the parameters'
    memory on the CPU, which the next step updates in place)."""
    return {k: np.array(v, copy=True) for k, v in flat.items()}


def _rank_steps(mesh, payload):
    if isinstance(payload, list):
        return [run_steps(mesh, p) for p in payload]
    return run_steps(mesh, payload)


def on_ranks(payload, ranks: int, device, backend: Optional[str] = None,
             devices: Optional[List] = None,
             store_dir: Optional[str] = None, n_model: int = 1):
    """run_steps on `ranks` ranks (parallel/mesh.run_ranks; a (ranks /
    n_model, n_model) mesh with n_model > 1); rank 0's result (one a
    payload, for a list of payloads)."""
    from ..parallel.mesh import run_ranks
    with tempfile.TemporaryDirectory(dir=store_dir) as td:
        return run_ranks(_rank_steps, ranks, td, device, backend=backend,
                         args=(payload,), devices=devices, n_model=n_model)


def compare(one: Dict, many: Dict) -> Dict:
    """Loss and gradient differences of two run_steps results: the last
    loss's absolute and relative difference, and every gradient's largest
    difference over its largest magnitude, with the worst and whether each
    is within the bounds (LOSS_TOL, GRAD_ATOL + GRAD_RTOL of scale)."""
    la, lb = one["loss"][-1], many["loss"][-1]
    rel = {}
    held = True
    for k, g in one["grads"].items():
        scale = float(np.abs(g).max())
        d = float(np.abs(many["grads"][k] - g).max())
        rel[k] = d / max(scale, 1e-30)
        held &= d <= GRAD_ATOL + GRAD_RTOL * scale
    worst = max(rel.items(), key=lambda kv: kv[1])
    loss_held = abs(la - lb) <= LOSS_TOL * max(1.0, abs(la))
    return {"loss": (la, lb), "loss_abs": abs(la - lb),
            "loss_rel": abs(la - lb) / max(abs(la), 1e-30),
            "grad_rel": rel, "worst": worst,
            "held": bool(held and loss_held)}


def flagship_payload(dtype: str = "float32", feat: int = 512,
                     batch: int = 1024, seed: int = 0, layers: int = 8,
                     kernels: bool = True) -> Dict:
    """The flagship stage-2 step (RPV(111), analytic normals and sun
    march, 64 + 64 samples; 8 layers, skip 4) at width `feat` and compute
    dtype `dtype` on a seeded synthetic store of 4 batches, one global
    index vector; kernels False: the render config without K1-K5."""
    from ..config import ModelConfig, RenderConfig, TrainConfig
    from ..parallel import train_step as ts
    from ..utils.checkpoint import params_to_flat
    mcfg = ModelConfig(variant="spsbrdf-nerf", siren=True, mapping=True,
                       layers=layers, feat=feat, skips=(4,),
                       normal="analystic", sun_v="analystic", func_m=True,
                       func_f=True, func_h=1, dim_rpv=1,
                       compute_dtype=dtype)
    rcfg = RenderConfig(n_samples=64, guided_samples=64, use_pallas=kernels,
                        fused_trunk=kernels, apply_brdf=True)
    tcfg = TrainConfig(lr=5e-4, batch_size=batch, ds_lambda=10.0,
                       nr_reg_an_lambda=0.1, hs_lambda=0.5)
    state, _ = ts.create_train_state(mcfg, tcfg, 4, seed=seed,
                                     device="cpu")
    rng = np.random.RandomState(seed)
    n = 4 * batch
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = np.tile(np.asarray([[0.05, 0.02, -1.0]], np.float32), (n, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sun = np.tile(np.asarray([[0.3, 0.2, 0.93]], np.float32), (n, 1))
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.zeros((n, 1), np.float32),
                           np.full((n, 1), 2.0, np.float32), sun], 1)
    store = {"rays": rays,
             "rgbs": rng.uniform(0, 1, (n, 3)).astype(np.float32),
             "ts": np.zeros(n, np.int32),
             "depths": np.stack([rng.uniform(0.5, 1.5, n), np.ones(n)],
                                1).astype(np.float32),
             "valid_depth": (rng.uniform(0, 1, n) > 0.5).astype(np.int32),
             "depth_std": np.zeros(n, np.float32)}
    return {"mcfg": mcfg, "rcfg": rcfg, "tcfg": tcfg,
            "sched": dict(t_cos_irra=1e18, t_ds_drop=1e18, t_nrrg=-1.0,
                          steps_per_epoch=1, first_beta_epoch=0),
            "flat": params_to_flat(state.params), "store": store,
            "idx": [rng.permutation(n)[:batch].astype(np.int32)],
            "seed": seed + 1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: the device's; ranks that "
                        "share one card need gloo)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--feat", type=int, default=512)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    payload = flagship_payload(args.dtype, args.feat, args.batch)
    one = run_steps(None, payload, device=dev)
    devices = None
    if dev.type == "cuda" and torch.cuda.device_count() < args.ranks:
        devices = ["cuda:0"] * args.ranks
    many = on_ranks(payload, args.ranks, dev, backend=args.backend,
                    devices=devices)
    c = compare(one, many)
    print(json.dumps({"loss": c["loss"], "loss_rel": c["loss_rel"],
                      "worst_grad": c["worst"], "held": c["held"]}))
    return 0 if c["held"] else 1


if __name__ == "__main__":
    sys.exit(main())

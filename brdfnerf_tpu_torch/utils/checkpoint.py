"""Checkpoint I/O in the JAX package's flat npz layout.

A checkpoint is one `.npz` keyed by the parameter path
(`coarse/fc_net/0/w`, `coarse/fc_net/0/b`, ..., `fine/...` of a fine
network, `t` of the transient embedding table) plus `__step__`, so a
checkpoint written by either package loads in the other.  The npz stores
each weight as (in, out); `Network` keeps nn.Linear's (out, in), and
`params_from_flat` / `params_to_flat` transpose, exactly.  Every function
here takes a models.network.Params; a bare Network stands for the coarse
network alone (its keys under `coarse/`, models.network.as_params).  Optimizer state goes
beside it as `.opt.npz` in the JAX package's leaf layout (save_opt_state).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.network import Network, Params, as_params, model_params

SEP = "/"
NET_KEY = "coarse"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists of arrays (and Networks, under their npz
    layout) -> {path: ndarray}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, (Network, Params)):
        for k, p in _module_flat(tree).items():
            out[f"{prefix}{k}"] = _to_numpy(k, p)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    elif torch.is_tensor(tree):
        out[prefix.rstrip(SEP)] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip(SEP)] = np.asarray(tree)
    return out


def _module_flat(module) -> Dict[str, torch.Tensor]:
    """{npz key under `module`: parameter}: 'fc_net.0.w' -> 'fc_net/0/w'."""
    return {n.replace(".", SEP): p for n, p in module.named_parameters()}


def named_flat(params) -> Dict[str, torch.Tensor]:
    """{npz key: parameter} of a Params: 'coarse/...', 'fine/...', 't'."""
    return _module_flat(as_params(params))


def _is_weight(key: str) -> bool:
    return key.endswith(f"{SEP}w")


def _to_numpy(key: str, p: torch.Tensor) -> np.ndarray:
    v = p.detach().to("cpu", torch.float32)
    return np.ascontiguousarray((v.t() if _is_weight(key) else v).numpy())


def params_to_flat(params) -> Dict[str, np.ndarray]:
    """Params -> {npz key: float32 ndarray}, weights as (in, out)."""
    return {k: _to_numpy(k, p) for k, p in named_flat(params).items()}


def params_from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                     device=None) -> Params:
    """{npz key: ndarray} (the layout of save_checkpoint) -> the Params on
    `device` (CUDA unless named) holding exactly those values: with the
    fine network where `flat` holds one ('fine/...'), with the t table
    where cfg.beta (models.network.model_params).  Every parameter must be
    present and nothing else."""
    fine = any(k.startswith(f"fine{SEP}") for k in flat)
    return load_params(model_params(cfg, int(fine), device=device), flat)


def load_params(net, flat: Dict[str, np.ndarray],
                include: Optional[Iterable[str]] = None, strict: bool = True,
                source: str = "the flat params"):
    """Copy the values of `flat` (the npz layout) into `net` (a Params)
    in place.  include: key prefixes; only matching entries are restored
    (the two-stage handoff).  A full strict load must cover every
    parameter and nothing else; a bare Network takes the coarse keys and
    skips the others (the other networks' and the t table's)."""
    if isinstance(net, Network):
        flat = {k: v for k, v in flat.items()
                if k.startswith(f"{NET_KEY}{SEP}")}
    params = named_flat(net)
    include = None if include is None else list(include)
    restored = set()
    for key, val in flat.items():
        if key.startswith("__"):
            continue
        if include is not None and not any(key.startswith(p)
                                           for p in include):
            continue
        if key not in params:
            if strict and include is None:
                raise KeyError(f"checkpoint key {key} not in the model")
            continue
        p = params[key]
        v = torch.from_numpy(np.array(val, np.float32))
        if _is_weight(key):
            v = v.t()
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(p.shape)} vs {tuple(val.shape)}")
        with torch.no_grad():
            p.copy_(v)
        restored.add(key)
    if not restored:
        raise ValueError(f"nothing restored from {source} "
                         f"(include={include})")
    if strict and include is None:
        missing = [k for k in params if k not in restored]
        if missing:
            raise ValueError(
                f"{source} is missing {len(missing)} parameters of this "
                f"model config (e.g. {missing[:3]}); use the handoff "
                f"include filter for partial restores")
    return net


def save_checkpoint(path: str, params: Any, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """params: a Params, or {'coarse': Network, ...} (or any nested tree of
    arrays)."""
    flat = _flatten(params)
    flat["__step__"] = np.asarray(step)
    if extra:
        for k, v in _flatten(extra).items():
            flat[f"__extra__{SEP}{k}"] = v
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    return path


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """The checkpoint as {key: ndarray}: an npz as it is, a reference
    (torch/Lightning) .ckpt / .pth / .pt converted on load
    (utils/torch_import), so --in_ckpts, resume and load_renderer take a
    checkpoint trained by the reference."""
    if path.endswith((".ckpt", ".pth", ".pt")):
        from .torch_import import import_torch_checkpoint
        return import_torch_checkpoint(path)
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def restore_params(net, path: str,
                   include: Optional[Iterable[str]] = None,
                   strict: bool = True):
    """Copy the checkpoint's values into `net` (a Params) in place
    (load_params; include e.g. ['coarse/fc_net'])."""
    return load_params(net, load_flat(path), include, strict, path)


def resolve_epoch_ckpt(ckpts_dir: str, epoch_number: int) -> str:
    """Path of epoch={n}: the .npz, else the reference's Lightning .ckpt
    (converted on load by load_flat)."""
    npz = os.path.join(ckpts_dir, f"epoch={epoch_number}.npz")
    if os.path.exists(npz):
        return npz
    torch_path = os.path.join(ckpts_dir, f"epoch={epoch_number}.ckpt")
    if os.path.exists(torch_path):
        return torch_path
    raise FileNotFoundError(f"neither {npz} nor {torch_path} found")


def checkpoint_step(path: str) -> int:
    """The `__step__` a checkpoint was saved at (0 when absent)."""
    return int(load_flat(path).get("__step__", np.asarray(0)))


# the stage-2 BRDF finetune restores exactly these heads from the stage-1
# checkpoint (main.py:97-104); the rgb head too unless the Hapke single-
# scattering albedo head replaces it
HANDOFF_HEADS = ("fc_net", "sigma_from_xyz", "feats_from_xyz")
HANDOFF_RGB = "rgb_from_xyzdir"


def handoff_include(net_key: str = NET_KEY, hapke_b: bool = False) -> list:
    """Key prefixes for the stage-1 -> stage-2 handoff (main.py:97-104)."""
    heads = list(HANDOFF_HEADS) + ([] if hapke_b else [HANDOFF_RGB])
    return [f"{net_key}{SEP}{h}" for h in heads]


def freeze_mask(net, frozen_prefixes: Iterable[str]) -> Dict[str, bool]:
    """{npz key: trainable} of the parameters (a Params):
    False where the key starts with a frozen prefix; 'all' freezes
    everything (the reference's freeze('all'), spsbrdfnerf.py:617-621)."""
    frozen = ["" if p == "all" else p for p in frozen_prefixes]
    return {k: not any(k.startswith(p) for p in frozen)
            for k in named_flat(net)}


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The highest-epoch epoch={n}.npz in a directory (the reference's file
    naming epoch={n}.ckpt, main.py:709-712), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    found = [(int(m.group(1)), f) for f in os.listdir(ckpt_dir)
             for m in [re.fullmatch(r"epoch=(\d+)\.npz", f)] if m]
    return os.path.join(ckpt_dir, max(found)[1]) if found else None


# -------------------------------------------------------- optimizer state
#
# The JAX package saves optax.adam's state as its tree leaves in
# jax.tree_util order, `leaf_0000` ...: the update count, then Adam's first
# moments (mu) of every trainable parameter in sorted key order (list
# entries by index), then the second moments (nu) in the same order, then
# the schedule's update count.  A freeze-all run keeps the two counts
# alone.  The port writes and reads that layout from torch.optim.Adam's
# state, weights transposed to (in, out), so either package resumes from
# the other's checkpoint.

def _jax_order(keys: Iterable[str]) -> list:
    return sorted(keys, key=lambda k: tuple(
        (0, int(c), "") if c.isdigit() else (1, 0, c)
        for c in k.split(SEP)))


def _trained(net, opt):
    """[(npz key, parameter)] of the parameters `opt` updates, in the JAX
    leaf order."""
    ids = ({id(p) for g in opt.param_groups for p in g["params"]}
           if opt is not None else set())
    named = {k: p for k, p in named_flat(net).items()
             if id(p) in ids}
    return [(k, named[k]) for k in _jax_order(named)]


def save_opt_state(path: str, net, opt, count: int) -> str:
    """Adam's state of `net` under `opt` (None: every parameter frozen) in
    the JAX package's leaf layout.  The update count is Adam's own where
    it holds state, else `count` (a frozen or not yet stepped optimizer)."""
    mu, nu = [], []
    for key, p in _trained(net, opt):
        st = opt.state.get(p, {})
        if "step" in st:
            count = int(st["step"])
        for out, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            v = st.get(name)
            v = (torch.zeros_like(p) if v is None else v).detach()
            v = v.to("cpu", torch.float32)
            out.append(np.ascontiguousarray(
                (v.t() if _is_weight(key) else v).numpy()))
    c = np.asarray(count, np.int32)
    leaves = [c] + mu + nu + [c]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{f"leaf_{i:04d}": v for i, v in enumerate(leaves)})
    return path


def restore_opt_state(net, opt, path: str) -> int:
    """Load a leaf-layout optimizer state into `opt` (in place) and return
    its update count.  A state of another optimizer configuration (leaf
    count or shapes) raises ValueError and leaves `opt` untouched."""
    flat = load_flat(path)
    trained = _trained(net, opt)
    n = len([k for k in flat if k.startswith("leaf_")])
    if n != 2 + 2 * len(trained):
        raise ValueError(
            f"optimizer-state leaf count mismatch: ckpt {n} vs template "
            f"{2 + 2 * len(trained)} (different optimizer config?)")
    count = int(flat["leaf_0000"])
    states = {}
    for i, (key, p) in enumerate(trained):
        moments = []
        for leaf in (1 + i, 1 + len(trained) + i):
            v = torch.from_numpy(np.array(flat[f"leaf_{leaf:04d}"],
                                          np.float32))
            if _is_weight(key):
                v = v.t()
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"opt-state leaf {leaf} shape mismatch: "
                                 f"{tuple(p.shape)} vs {tuple(v.shape)}")
            moments.append(v.contiguous().to(p.device))
        # torch.optim.Adam keeps `step` as a float32 scalar, on the
        # parameter's device for the fused implementation
        on_dev = opt.param_groups[0].get("fused") or opt.param_groups[0].get(
            "capturable")
        states[p] = {"step": torch.tensor(
            float(count), dtype=torch.float32,
            device=p.device if on_dev else "cpu"),
            "exp_avg": moments[0], "exp_avg_sq": moments[1]}
    if opt is not None:
        opt.state.update(states)
    return count

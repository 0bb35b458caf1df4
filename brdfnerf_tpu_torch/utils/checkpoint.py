"""Checkpoint I/O in the JAX package's flat npz layout.

A checkpoint is one `.npz` keyed by the parameter path
(`coarse/fc_net/0/w`, `coarse/fc_net/0/b`, ...) plus `__step__`, so a
checkpoint written by either package loads in the other.  The npz stores
each weight as (in, out); `Network` keeps nn.Linear's (out, in), and
`params_from_flat` / `params_to_flat` transpose, exactly.  Optimizer state
goes beside it as `.opt.npz` in the JAX package's leaf layout
(save_opt_state).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.network import Network
from .device import resolve_device

SEP = "/"
NET_KEY = "coarse"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists of arrays (and Networks, under their npz
    layout) -> {path: ndarray}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Network):
        for k, v in params_to_flat(tree, net_key="").items():
            out[f"{prefix}{k}"] = v
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


def _param_key(name: str, net_key: str) -> str:
    """'fc_net.0.w' -> 'coarse/fc_net/0/w'."""
    key = name.replace(".", SEP)
    return f"{net_key}{SEP}{key}" if net_key else key


def params_to_flat(net: Network, net_key: str = NET_KEY
                   ) -> Dict[str, np.ndarray]:
    """Network -> {npz key: float32 ndarray}, weights as (in, out)."""
    flat = {}
    for name, p in net.named_parameters():
        v = p.detach().to("cpu", torch.float32)
        if name.endswith(".w"):
            v = v.t()
        flat[_param_key(name, net_key)] = np.ascontiguousarray(v.numpy())
    return flat


def _load_into(net: Network, flat: Dict[str, np.ndarray], net_key: str,
               include: Optional[Iterable[str]], strict: bool,
               source: str) -> Network:
    params = {_param_key(n, net_key): p for n, p in net.named_parameters()}
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
        if key.endswith(f"{SEP}w"):
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


def params_from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                     device=None, net_key: str = NET_KEY) -> Network:
    """{npz key: ndarray} (the layout of save_checkpoint) -> a Network on
    `device` (CUDA unless named) holding exactly those values.  Every
    parameter of the config must be present and nothing else under
    `net_key`."""
    net = Network(cfg, device=resolve_device(device))
    return _load_into(net, {k: v for k, v in flat.items()
                            if k.startswith(f"{net_key}{SEP}")},
                      net_key, None, True, "the flat params")


def save_checkpoint(path: str, params: Any, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """params: {'coarse': Network, ...} (or any nested tree of arrays)."""
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


def restore_params(net: Network, path: str,
                   include: Optional[Iterable[str]] = None,
                   strict: bool = True, net_key: str = NET_KEY) -> Network:
    """Copy the checkpoint's values into `net` in place.

    include: key prefixes (e.g. ['coarse/fc_net']); only matching entries
    are restored (the two-stage handoff).  A full strict restore must cover
    every parameter of the model; keys outside `net_key` are not the
    network's and are skipped."""
    flat = {k: v for k, v in load_flat(path).items()
            if k.startswith(f"{net_key}{SEP}")}
    return _load_into(net, flat, net_key, include, strict, path)


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


def freeze_mask(net: Network, frozen_prefixes: Iterable[str],
                net_key: str = NET_KEY) -> Dict[str, bool]:
    """{npz key: trainable} of the network's parameters: False where the key
    starts with a frozen prefix; 'all' freezes everything (the reference's
    freeze('all'), spsbrdfnerf.py:617-621)."""
    frozen = ["" if p == "all" else p for p in frozen_prefixes]
    return {_param_key(n, net_key): not any(
        _param_key(n, net_key).startswith(p) for p in frozen)
        for n, _ in net.named_parameters()}


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


def _trained(net: Network, opt, net_key: str):
    """[(npz key, parameter)] of the parameters `opt` updates, in the JAX
    leaf order."""
    ids = ({id(p) for g in opt.param_groups for p in g["params"]}
           if opt is not None else set())
    named = {_param_key(n, net_key): p for n, p in net.named_parameters()
             if id(p) in ids}
    return [(k, named[k]) for k in _jax_order(named)]


def save_opt_state(path: str, net: Network, opt, count: int,
                   net_key: str = NET_KEY) -> str:
    """Adam's state of `net` under `opt` (None: every parameter frozen) in
    the JAX package's leaf layout.  The update count is Adam's own where
    it holds state, else `count` (a frozen or not yet stepped optimizer)."""
    mu, nu = [], []
    for key, p in _trained(net, opt, net_key):
        st = opt.state.get(p, {})
        if "step" in st:
            count = int(st["step"])
        for out, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            v = st.get(name)
            v = (torch.zeros_like(p) if v is None else v).detach()
            v = v.to("cpu", torch.float32)
            out.append(np.ascontiguousarray(
                (v.t() if key.endswith(f"{SEP}w") else v).numpy()))
    c = np.asarray(count, np.int32)
    leaves = [c] + mu + nu + [c]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{f"leaf_{i:04d}": v for i, v in enumerate(leaves)})
    return path


def restore_opt_state(net: Network, opt, path: str,
                      net_key: str = NET_KEY) -> int:
    """Load a leaf-layout optimizer state into `opt` (in place) and return
    its update count.  A state of another optimizer configuration (leaf
    count or shapes) raises ValueError and leaves `opt` untouched."""
    flat = load_flat(path)
    trained = _trained(net, opt, net_key)
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
            if key.endswith(f"{SEP}w"):
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

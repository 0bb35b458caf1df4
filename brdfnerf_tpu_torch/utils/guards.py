"""Numerics guards: the reference's NaN/validity sanitizer inventory
(train_utils.check_nan:61-78, check_badnr:49-59, check_vec0:14-26,
spsbrdfnerf.checknan:32-48) as a debug layer that costs nothing when off;
the port's copy of the JAX package's utils/guards.py.

The trig-heavy BRDFs produce NaNs near grazing angles; the value
replacement (nan_to_num with the reference's fill conventions) lives in the
BRDF code itself, and detection is this module: enable with
BRDFNERF_DEBUG_NUMERICS=1, guards.enable() or the train CLI's
--print_debuginfo, and every guarded tensor reports its NaN/Inf counts.
checkify_wrap(fn) is the counterpart of jax.experimental.checkify's NaN
checks: the wrapped function returns (err, out), and err names the first
op whose output holds a NaN where its inputs held none.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ENABLED = bool(int(os.environ.get("BRDFNERF_DEBUG_NUMERICS", "0")))


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def _report(name: str, n_nan: int, n_inf: int, n_total: int):
    if n_nan or n_inf:
        print(f"[numerics] {name}: {n_nan} NaN, {n_inf} Inf of {n_total}")


def guard(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity; when debug is on, reports NaN/Inf counts (one host copy)."""
    if not _ENABLED:
        return x
    with torch.no_grad():
        counts = torch.stack([torch.isnan(x).sum(), torch.isinf(x).sum()])
        n_nan, n_inf = (int(v) for v in counts.cpu())
    _report(name, n_nan, n_inf, x.numel())
    return x


def guard_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Guard every tensor in a result dict (spsbrdfnerf.checknan analog)."""
    if not _ENABLED:
        return tree
    return {k: guard(v, f"{prefix}{k}") if isinstance(v, torch.Tensor)
            else v for k, v in tree.items()}


def replace_nan(x: torch.Tensor, value: float = 0.0,
                name: str = "") -> torch.Tensor:
    """check_nan semantics: report (when debug) then value-replace."""
    if _ENABLED and name:
        guard(x, name)
    return torch.nan_to_num(x, nan=value)


def safe_pow(base: torch.Tensor, exp: torch.Tensor,
             eps: float = 1e-8) -> torch.Tensor:
    """check_badnr analog: clamp the base away from <= 0 before a
    fractional power (negative-base pow is the reference's top NaN source,
    train_utils.py:49-59)."""
    return torch.pow(torch.clamp(base, min=eps), exp)


def unit_fraction(v: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """check_vec0 analog: fraction of rows whose norm deviates from 1."""
    n = torch.linalg.vector_norm(v, dim=-1)
    return torch.mean((torch.abs(n - 1.0) > eps).to(torch.float32))


class NanError:
    """What checkify_wrap found: get() is None, or a message naming the
    first op that made a NaN from inputs without one; throw() raises it."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self):
        if self.message is not None:
            raise FloatingPointError(self.message)


def _has_nan(values) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_floating_point()
               and bool(torch.isnan(t).any()) for t in values)


class _NanWatch(TorchDispatchMode):
    """Runs every op as it is and keeps the first one whose outputs hold a
    NaN that its inputs did not."""

    def __init__(self):
        super().__init__()
        self.first: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.first is None and _has_nan(tree_leaves(out)) \
                and not _has_nan(tree_leaves((args, kwargs))):
            self.first = f"nan generated by primitive: {func}"
        return out


def checkify_wrap(fn: Callable, *static_argnums) -> Callable:
    """fn wrapped to return (err, out): err.get() names the first op that
    produced a NaN (jax.experimental.checkify's nan_checks), or is None.
    static_argnums is accepted for the JAX signature's sake."""
    def checked(*args, **kwargs):
        watch = _NanWatch()
        with watch:
            out = fn(*args, **kwargs)
        return NanError(watch.first), out
    return checked

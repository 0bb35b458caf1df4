"""Polynomial sine for the siren trunk (counterpart of the JAX package's
ops/fast_math.py, same constants).

Range reduction to [-pi, pi] then a degree-9 odd least-squares polynomial:
1.7e-5 max abs error.  `torch.round` rounds half to even like `jnp.round`;
the CUDA kernels use `rintf`, which does the same (`roundf` does not).
Where autograd records nothing (the kernels' twins, serving), the
polynomials run in place in one fresh buffer: the same operations in the
same order, bit for bit the nested expressions, at a fraction of their
memory traffic (the twins' CPU time in chip_smoke.py's checks).
"""

from __future__ import annotations

import torch

# least-squares fit of sin on [-pi, pi] over odd powers x^1..x^9
_C1 = 9.999845867745e-01
_C3 = -1.666325820430e-01
_C5 = 8.312382933817e-03
_C7 = -1.931618219602e-04
_C9 = 2.173210068083e-06
_TWO_PI = 6.283185307179586
_INV_2PI = 0.15915494309189535


def needs_graph(x: torch.Tensor) -> bool:
    """Whether autograd records operations on x (then no intermediate of a
    polynomial of x may be overwritten)."""
    return torch.is_grad_enabled() and x.requires_grad


def reduce_range(x: torch.Tensor) -> torch.Tensor:
    """x - 2 pi round(x / (2 pi)), in place of one fresh buffer where no
    graph is recorded (x + (-t) is x - t exactly in IEEE arithmetic)."""
    if needs_graph(x):
        return x - _TWO_PI * torch.round(x * _INV_2PI)
    return x.mul(_INV_2PI).round_().mul_(_TWO_PI).neg_().add_(x)


def horner(v2: torch.Tensor, coeffs, scale=None) -> torch.Tensor:
    """c[0] + v2 * (c[1] + ... + v2 * (c[-2] + v2 * c[-1])) with the nested
    expression's operations in its order (with scale, the innermost term
    is v2 * scale * c[-1], that is (v2 * scale) * c[-1]; products and sums
    commute exactly), in one fresh buffer where no graph is recorded."""
    *rest, last = coeffs
    if needs_graph(v2):
        p = rest[-1] + (v2 if scale is None else v2 * scale) * last
        for c in reversed(rest[:-1]):
            p = c + v2 * p
        return p
    p = v2.mul(last) if scale is None else v2.mul(scale).mul_(last)
    p.add_(rest[-1])
    for c in reversed(rest[:-1]):
        p.mul_(v2).add_(c)
    return p


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) to ~1.7e-5 absolute accuracy."""
    v = reduce_range(x)
    v2 = v * v
    p = horner(v2, (_C1, _C3, _C5, _C7, _C9))
    return v * p if needs_graph(p) else p.mul_(v)

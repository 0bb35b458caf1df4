"""Positional (Fourier-feature) encoding, identity term excluded
(reference: models/nerf.py:36-70).

Layout per frequency f in (1, 2, 4, ...): [sin(f*x), cos(f*x)], each a
C-wide block, so the encoded width is 2 * n_freqs * C.  The encoding is
sin(m) with m = x @ P + phase, where P places 2^f at each [sin, cos] slot
and phase adds pi/2 on the cos slots.  P has one non-zero (a power of two)
per column, so m is computed here as an exact elementwise product,
x[..., chan] * scale: the same f32 values as the JAX package's HIGHEST
precision matmul, and no TF32 or bf16 matmul path can round the
coordinates.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _proj_and_phase(n_freqs: int, in_ch: int, pad_to: int = 0):
    """NumPy constants (P (C, W), phase (W,)), W = max(2*n_freqs*C, pad_to).

    pad_to: minimum output width; extra columns are zero in both P and
    phase, so the padded encoding lanes are exactly sin(0) = 0 (the fused
    trunk kernels take 128-wide inputs)."""
    width = 2 * n_freqs * in_ch
    p = np.zeros((in_ch, max(width, pad_to)), np.float32)
    phase = np.zeros((max(width, pad_to),), np.float32)
    for f in range(n_freqs):
        base = f * 2 * in_ch
        for c in range(in_ch):
            p[c, base + c] = 2.0 ** f              # sin slot
            p[c, base + in_ch + c] = 2.0 ** f      # cos slot
            phase[base + in_ch + c] = math.pi / 2.0
    return p, phase


@lru_cache(maxsize=None)
def _phase_tensors(n_freqs: int, in_ch: int, pad_to: int, dtype: torch.dtype,
                   device: torch.device):
    """(chan, scale, phase) of _proj_and_phase on `device`, made once: a
    host-to-device copy would wait for the device's queue at every call.
    Shared: read only."""
    p, phase = _proj_and_phase(n_freqs, in_ch, pad_to)
    return (torch.as_tensor(p.argmax(axis=0), device=device),
            torch.as_tensor(p.max(axis=0), device=device, dtype=dtype),
            torch.as_tensor(phase, device=device, dtype=dtype))


def _phase_arg(x: torch.Tensor, n_freqs: int, pad_to: int = 0) -> torch.Tensor:
    """m = x @ P + phase, computed exactly: each column of P holds one
    power of two (or nothing, on pad columns)."""
    chan, scale, phase = _phase_tensors(n_freqs, x.shape[-1], pad_to,
                                        x.dtype, x.device)
    return x[..., chan] * scale + phase


def positional_encoding(x: torch.Tensor, n_freqs: int, fast: bool = False,
                        pad_to: int = 0) -> torch.Tensor:
    """Encode x (..., C) -> (..., max(2*n_freqs*C, pad_to)).

    fast: use the polynomial sine of ops/fast_math (the kernels' sine).
    pad_to: emit at least this width, extra lanes identically 0.  No effect
    when n_freqs == 0 (x passes through)."""
    if n_freqs == 0:
        return x
    m = _phase_arg(x, n_freqs, pad_to)
    if fast:
        from .fast_math import fast_sin
        return fast_sin(m)
    return torch.sin(m)

"""DSM registration: multiscale NaN-aware NCC translation search.

Re-implements dsmr.py's numba-JIT pixel loops (dsmr.py:6-135) as vectorized
NumPy: the NCC for one candidate shift is a handful of masked array
reductions over the overlap window, the +/-irange search is a small Python
loop over those, and the pyramid recursion halves the image while
min(h, w) > 100 (dsmr.py:120-135).  Registration output is the affine
z-mapping z -> a*z + b plus the integer pixel shift (dx, dy)
(dsmr.compute_shift:163-190).

The port's copy of the JAX package's geo/registration.py, NumPy path only:
the JAX package's native C++ NCC pass for large DSMs is not copied
(ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _overlap(u: np.ndarray, v: np.ndarray, dx: int, dy: int):
    """Aligned views: u[j, i] vs v[j + dy, i + dx] over valid indices."""
    h, w = u.shape
    ui0, ui1 = max(0, -dx), min(w, v.shape[1] - dx)
    uj0, uj1 = max(0, -dy), min(h, v.shape[0] - dy)
    if ui1 <= ui0 or uj1 <= uj0:
        return None, None
    uu = u[uj0:uj1, ui0:ui1]
    vv = v[uj0 + dy:uj1 + dy, ui0 + dx:ui1 + dx]
    return uu, vv


def masked_stats(u: np.ndarray, v: np.ndarray, dx: int = 0, dy: int = 0):
    """(muu, muv, sigu, sigv, xcorr) over jointly-finite pixels
    (dsmr.mean_std:48-88)."""
    uu, vv = _overlap(u, v, dx, dy)
    if uu is None:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    m = np.isfinite(uu) & np.isfinite(vv)
    n = int(m.sum())
    if n == 0:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    a = uu[m]
    b = vv[m]
    muu, muv = a.mean(), b.mean()
    da, db = a - muu, b - muv
    sigu = np.sqrt(np.mean(da * da))
    sigv = np.sqrt(np.mean(db * db))
    xcorr = np.mean(da * db)
    return float(muu), float(muv), float(sigu), float(sigv), float(xcorr)


def ncc(u, v, dx: int = 0, dy: int = 0) -> float:
    muu, muv, sigu, sigv, xcorr = masked_stats(u, v, dx, dy)
    denom = sigu * sigv
    return xcorr / denom if denom > 0 else -np.inf


def search_shift(u, v, irange: int = 5, dx: int = 0, dy: int = 0):
    """argmax NCC over (dx, dy) +/- irange (dsmr.compute_ncc:100-117)."""
    best = (-np.inf, dx, dy)
    for y in range(dy - irange, dy + irange + 1):
        for x in range(dx - irange, dx + irange + 1):
            c = ncc(u, v, x, y)
            if c > best[0]:
                best = (c, x, y)
    return best[1], best[2]


def downsample2x(u: np.ndarray) -> np.ndarray:
    """NaN-aware 2x block mean (dsmr.downsample2x:16-45)."""
    h, w = u.shape
    ph, pw = -h % 2, -w % 2
    up = np.pad(u, ((0, ph), (0, pw)), constant_values=np.nan)
    blocks = up.reshape(up.shape[0] // 2, 2, up.shape[1] // 2, 2)
    import warnings
    with warnings.catch_warnings():
        # all-NaN 2x2 blocks are expected (they stay NaN); the complaint
        # is a warnings-module RuntimeWarning, not an FP error state
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmean(blocks, axis=(1, 3))


def multiscale_shift(u, v, irange: int = 5, dx: int = 0, dy: int = 0):
    """Pyramid NCC search (dsmr.recursive_ncc:120-135)."""
    if min(u.shape) > 100:
        sdx, sdy = multiscale_shift(downsample2x(u), downsample2x(v),
                                    irange, dx // 2, dy // 2)
        dx, dy = sdx * 2, sdy * 2
    return search_shift(u, v, irange, dx, dy)


def compute_shift(dsm_ref: np.ndarray, dsm_sec: np.ndarray,
                  scaling: bool = True) -> Tuple[int, int, float, float]:
    """Shift registering dsm_sec onto dsm_ref: returns (dx, dy, a, b) with
    z' = a * z + b (dsmr.compute_shift:163-190)."""
    dx, dy = multiscale_shift(dsm_ref, dsm_sec)
    muu, muv, sigu, sigv, _ = masked_stats(dsm_ref, dsm_sec, dx, dy)
    a = (sigu / sigv) if (scaling and sigv > 0) else 1.0
    b = muu - muv * a
    return dx, dy, a, b


def apply_shift(v: np.ndarray, dx: int = 0, dy: int = 0,
                a: float = 1.0, b: float = 0.0) -> np.ndarray:
    """out[j, i] = a * v[j + dy, i + dx] + b, NaN outside
    (dsmr.apply_shift_:138-151)."""
    h, w = v.shape
    out = np.full_like(v, np.nan, dtype=np.float64)
    ui0, ui1 = max(0, -dx), min(w, w - dx)
    uj0, uj1 = max(0, -dy), min(h, h - dy)
    if ui1 <= ui0 or uj1 <= uj0:
        return out
    out[uj0:uj1, ui0:ui1] = a * v[uj0 + dy:uj1 + dy, ui0 + dx:ui1 + dx] + b
    return out

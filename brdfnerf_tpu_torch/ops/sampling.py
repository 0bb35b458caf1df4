"""Ray samplers: stratified, inverse-CDF importance, Gaussian guided
(reference: rendering.py:13-166).

Every sampler takes its uniform draws as a tensor `u` (or draws them from a
`torch.Generator` when `u` is None), so a test can hand the port and the
JAX package the same draws.

  * stratified_z_vals          <- get_z_vals            (rendering.py:149-166)
  * sample_pdf                 <- sample_pdf            (rendering.py:13-52)
  * sample_gaussian_3sigma     <- sample_3sigma         (rendering.py:54-74)
  * sample_gaussian_3sigma_sym <- sample_3sigma_asym    (rendering.py:76-91)
  * samples_around_depth       <- compute_samples_around_depth (rendering.py:116-130)
  * guided_samples             <- GenerateGuidedSamples (rendering.py:132-147)
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .compositing import depth_std


@lru_cache(maxsize=None)
def _linspace_np(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num)` in f32 as XLA compiles it on the
    CPU: s_i = i * f32(1/div); start*(1 - s_i) in f32; then f32(stop/div)*i
    added with one rounding (a fused multiply-add); the last point is
    exactly `stop`.  Bit-exact for start = 0 (every call in the render
    path but the Gaussian band's abscissae), within 1 ulp otherwise."""
    f = np.float32
    if num == 1:
        return np.asarray([start], f)
    div = num - 1
    r = f(1.0 / div)
    i = np.arange(div, dtype=f)
    head = (f(start) * (f(1) - i * r)).astype(f)
    out = (np.float64(f(stop) * r) * i.astype(np.float64)
           + head.astype(np.float64)).astype(f)
    return np.concatenate([out, np.asarray([stop], f)])


@lru_cache(maxsize=None)
def _linspace_on(start: float, stop: float, num: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.tensor(_linspace_np(start, stop, num), dtype=dtype,
                        device=device)


def linspace(start: float, stop: float, num: int,
             like: torch.Tensor) -> torch.Tensor:
    """jnp.linspace's f32 values (see _linspace_np) on like's device.
    `torch.linspace` steps from both ends and differs in the last ulp,
    which the siren trunk amplifies.  Uploaded once per (values, dtype,
    device): a host-to-device copy of pageable memory waits for the
    device's queue, so uploading anew would stall every render chunk and
    train step.  A copy on the device: the cached tensor is shared."""
    return _linspace_on(float(start), float(stop), num, like.dtype,
                        like.device).clone()


def _uniform(u, shape, like, generator):
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"draws of shape {tuple(u.shape)}, "
                             f"need {tuple(shape)}")
        return u.to(device=like.device, dtype=like.dtype)
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def stratified_z_vals(n_samples: int, near, far, use_disp: bool = False,
                      perturb: float = 1.0, u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """Linear (or disparity-linear) depths near->far with jittered
    midpoints.  near/far: (N_rays, 1).  Returns (N_rays, n_samples)."""
    t = linspace(0.0, 1.0, n_samples, like=near)
    if not use_disp:
        z = near * (1.0 - t) + far * t
    else:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    if perturb > 0:
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        upper = torch.cat([mid, z[:, -1:]], -1)
        lower = torch.cat([z[:, :1], mid], -1)
        z = lower + (upper - lower) * (
            perturb * _uniform(u, z.shape, z, generator))
    return z


def sample_pdf(bins, weights, n_importance: int, det: bool = False,
               eps: float = 1e-5, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """Inverse-CDF sampling of a histogram.

    bins: (N, B+1) edges; weights: (N, B).  Returns (N, n_importance)."""
    n_rays, n_bins = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)   # (N, B+1)
    if det:
        u = linspace(0.0, 1.0, n_importance, like=bins)
        u = torch.broadcast_to(u, (n_rays, n_importance)).contiguous()
    else:
        u = _uniform(u, (n_rays, n_importance), bins, generator)
    return _inv_cdf_lookup(cdf, bins, u, n_bins=n_bins, eps=eps)


def _inv_cdf_lookup(cdf, bins, u, n_bins: int, eps: float):
    """searchsorted(cdf, u, right) then linear interpolation between the
    bracketing bins.  The JAX package counts #(cdf <= u) and gathers through
    one-hot matmuls at HIGHEST precision (a TPU layout choice); the counts
    and gathered values here are the same numbers."""
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n_bins)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bin_lo = torch.gather(bins, 1, below)
    bin_hi = torch.gather(bins, 1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def sample_gaussian_3sigma(low, high, n: int, det: bool,
                           d_range: float = 3.0, eps: float = 1e-5,
                           u: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None):
    """n samples under a Gaussian spanning [low, high] (= mu +/- d_range*sigma).

    low/high: (N_rays,).  Returns sorted (N_rays, n)."""
    t = linspace(0.0, 1.0, n, like=low)
    step = (high - low) / (n - 1)
    edges = low[:, None] * (1.0 - t) + high[:, None] * t
    factor = (edges[:, 1:] - edges[:, :-1]) / (step[:, None] + eps)
    x = linspace(-d_range, d_range, n - 1, like=low)
    gauss = (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * x * x)
    w = factor * gauss[None, :]
    res = sample_pdf(edges, w, n, det=det, u=u, generator=generator)
    return torch.sort(res, -1).values


def sample_gaussian_3sigma_sym(depth, low, high, n: int, det: bool, near, far,
                               d_range: float = 3.0,
                               u: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None):
    """Symmetrize the band about `depth` (min one-sided range), then sample.
    depth/low/high: (N_rays,); near/far: scalars (0-d tensors or floats)."""
    low = torch.clamp(low, near, far)
    high = torch.clamp(high, near, far)
    rng = torch.minimum(torch.abs(high - depth), torch.abs(low - depth))
    return sample_gaussian_3sigma(depth - rng, depth + rng, n, det,
                                  d_range=d_range, u=u, generator=generator)


def samples_around_depth(pred_depth, pred_weight, z_vals, n: int, det: bool,
                         near, far, d_range: float = 3.0,
                         u: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
    """Gaussian band centred on the predicted depth with predicted std."""
    std = torch.nan_to_num(depth_std(z_vals, pred_depth, pred_weight))
    pred_depth = torch.nan_to_num(pred_depth)
    return sample_gaussian_3sigma_sym(
        pred_depth, pred_depth - d_range * std, pred_depth + d_range * std,
        n, det, near, far, d_range=d_range, u=u, generator=generator)


def guided_samples(pred_depth, pred_weight, z_vals, n: int, near, far,
                   train: bool = False, valid_depth=None, target_depth=None,
                   target_std=None, d_range: float = 3.0,
                   perturb: float = 1.0, u: Optional[torch.Tensor] = None,
                   u_gt: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Guided z-samples; at train time rays with valid GT depth take
    GT-centred Gaussians instead (rendering.py:135-145, as a where-mask).
    u / u_gt: the draws of the predicted-depth and GT-depth bands."""
    det = perturb == 0.0
    z2 = samples_around_depth(pred_depth, pred_weight, z_vals, n, det,
                              near, far, d_range=d_range, u=u,
                              generator=generator)
    if train and valid_depth is not None:
        lo = target_depth - d_range * target_std
        hi = target_depth + d_range * target_std
        gt = sample_gaussian_3sigma_sym(target_depth, lo, hi, n, det,
                                        near, far, d_range=d_range, u=u_gt,
                                        generator=generator)
        z2 = torch.where((valid_depth > 0)[:, None], gt, z2)
    return z2

"""Volume-rendering compositing (reference: models/spsbrdfnerf.py:50-69,
models/nerf.py:117-133): the last delta is 1e10,
alpha = 1 - exp(-delta * relu(sigma + noise)), T is the shifted cumulative
product of (1 - alpha + 1e-10), weights = alpha * T.
"""

from __future__ import annotations

from typing import Optional

import torch


class _CumprodNonzero(torch.autograd.Function):
    """torch.cumprod along the last axis of a tensor with no zero element,
    with torch's own backward for that case (the reversed cumulative sum
    of output * grad, divided by the input) but without the check for
    zeros by which torch's waits on the device (cumprod_backward's
    (input != 0).all().item() outside grad mode)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, -1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.flip(out * grad, [-1]).cumsum(-1),
                          [-1]).div(x)


def composite(z_vals: torch.Tensor, sigmas: torch.Tensor,
              noise_std: float = 0.0, noise: Optional[torch.Tensor] = None):
    """Alpha-composite densities along rays.

    z_vals, sigmas: (N_rays, N_samples).  noise: N(0, 1) draws of sigmas'
    shape; with noise_std > 0, sigma + noise_std * noise is composited
    (the density noise, opt.py:180-181).
    Returns (alphas, transparency, weights, depth)."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], -1)
    if noise_std > 0.0 and noise is not None:
        sigmas = sigmas + noise_std * noise.to(sigmas)
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1.0 - alphas + 1e-10], -1)
    # every factor is at least 1e-10
    transparency = _CumprodNonzero.apply(shifted)[:, :-1]
    weights = alphas * transparency
    depth = torch.sum(weights * z_vals, -1)
    return alphas, transparency, weights, depth


def depth_var(z_vals, depth, weights):
    """Weighted depth variance (train_utils.py:38-39)."""
    return torch.sum((z_vals - depth[..., None]) ** 2 * weights, -1)


def depth_std(z_vals, depth, weights):
    """Weighted depth std (train_utils.py:35-36)."""
    return torch.sqrt(depth_var(z_vals, depth, weights))


def l2_normalize(x, eps: float = 1.1920929e-07):
    """Unit-normalize along the last axis; eps floors the squared norm
    (train_utils.py:28-33)."""
    norm = torch.sum(x * x, -1, keepdim=True)
    return x / torch.sqrt(torch.clamp(norm, min=eps))

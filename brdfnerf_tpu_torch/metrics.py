"""Image metrics with the reference's conventions (counterpart of the JAX
package's metrics.py; SSIM and masked_scores are not ported yet).

PSNR normalises the squared error by max(gt)^2 (metrics.py:292-316), not by
a fixed peak of 1.0.
"""

from __future__ import annotations

import torch


def mse(image_pred, image_gt, valid_mask=None):
    """Mean squared error over max(gt)^2; with a mask, the mean over the
    masked elements (the mask broadcasts across channels)."""
    value = (image_pred - image_gt) ** 2
    value = value / (torch.max(image_gt) ** 2)
    if valid_mask is not None:
        m = torch.broadcast_to(valid_mask, value.shape).to(value.dtype)
        return torch.sum(value * m) / torch.clamp(torch.sum(m), min=1)
    return torch.mean(value)


def psnr(image_pred, image_gt, valid_mask=None):
    return -10.0 * torch.log10(mse(image_pred, image_gt, valid_mask))

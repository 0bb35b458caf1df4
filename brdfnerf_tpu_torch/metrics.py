"""Image metrics with the reference's conventions (counterpart of the JAX
package's metrics.py).

PSNR normalises the squared error by max(gt)^2 (metrics.py:292-316), not by
a fixed peak of 1.0.  SSIM reproduces kornia==0.5.3 `kornia.losses.ssim` as
the reference calls it (metrics.py:327-341): a 3x3 Gaussian window (sigma
1.5), a same-size map by reflect padding, eps=1e-12 on the denominator, the
mean of the map, max_val = max(gt).  The masked convention multiplies both
images by the mask first (main.py:607, eval.py:471).
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


def _gaussian_kernel(window: int, sigma: float, dtype):
    x = torch.arange(window, dtype=dtype) - (window - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def ssim(image_pred, image_gt, window: int = 3, max_val=None,
         eps: float = 1e-12):
    """SSIM over (C, H, W) or (H, W, C) images: a separable Gaussian window
    (sigma 1.5) along H then W, reflect-padded to the same size,
    num / (den + eps), mean."""
    if image_pred.ndim == 3 and image_pred.shape[0] in (1, 3):
        pred, gt = image_pred, image_gt
    else:
        pred = torch.movedim(image_pred, -1, 0)
        gt = torch.movedim(image_gt, -1, 0)
    if max_val is None:
        max_val = torch.max(gt)
    k = _gaussian_kernel(window, 1.5, pred.dtype).to(pred.device)
    pad = (window - 1) // 2

    def conv1d(x, axis):
        x = torch.movedim(x, axis, -1)
        # reflect padding of the last axis (numpy's 'reflect': no edge
        # repeat)
        x = torch.cat([x[..., 1:pad + 1].flip(-1), x,
                       x[..., -pad - 1:-1].flip(-1)], -1)
        n = x.shape[-1] - window + 1
        out = torch.zeros(x.shape[:-1] + (n,), dtype=x.dtype,
                          device=x.device)
        for i in range(window):
            out = out + k[i] * x[..., i:i + n]
        return torch.movedim(out, -1, axis)

    def blur(img):
        return conv1d(conv1d(img, 1), 2)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_p = blur(pred)
    mu_g = blur(gt)
    mu_pg = mu_p * mu_g
    sigma_p = blur(pred * pred) - mu_p ** 2
    sigma_g = blur(gt * gt) - mu_g ** 2
    sigma_pg = blur(pred * gt) - mu_pg
    num = (2 * mu_pg + c1) * (2 * sigma_pg + c2)
    den = (mu_p ** 2 + mu_g ** 2 + c1) * (sigma_p + sigma_g + c2)
    return torch.mean(num / (den + eps))


def scale_images(img1, img2):
    """Rescale both by max of img2 (sclimg, metrics.py:301-308)."""
    max_ = torch.max(img2)
    return img1 / max_, img2 / max_


def masked_scores(rgb, gt, mask=None, scl: bool = False,
                  with_unmasked: bool = False):
    """The reference's masked PSNR/SSIM scoring (main.py:603-607,
    eval.py:469-471), as the JAX package's masked_scores:

      psnr      masked per element (the mask inside the MSE mean)
      ssim      ssim(pred*mask, gt*mask)
      *_all     with_unmasked=True: the unmasked pair as well
      *_scl     scl=True: the max(gt)-rescaled pair, same masking

    mask: (H, W, 1) tensor or None.  Returns a dict of Python floats."""
    if mask is not None:
        p = float(psnr(rgb, gt, mask))
        s = float(ssim(rgb * mask, gt * mask))
    else:
        p = float(psnr(rgb, gt))
        s = float(ssim(rgb, gt))
    out = {"psnr": p, "ssim": s}
    if with_unmasked:
        out["psnr_all"] = p if mask is None else float(psnr(rgb, gt))
        out["ssim_all"] = s if mask is None else float(ssim(rgb, gt))
    if scl:
        rgb_s, gt_s = scale_images(rgb, gt)
        out["psnr_scl"] = float(psnr(rgb_s, gt_s, mask))
        out["ssim_scl"] = float(ssim(rgb_s * mask, gt_s * mask)
                                if mask is not None else ssim(rgb_s, gt_s))
    return out

"""Image-quality metrics for splat training/eval: PSNR and SSIM (the
counterpart of the JAX package's ``utils/image_metrics.py``).

3DGS training pipelines report PSNR/SSIM and optimize
``0.8 * L1 + 0.2 * (1 - SSIM)`` (the original 3DGS paper's loss).  All
three are differentiable PyTorch functions.  The SSIM window is summed tap
by tap in float32, not by a convolution: a float32 convolution on the card
runs through cuDNN in TF32 by default.
"""

from __future__ import annotations

import math

import torch


def psnr(img: torch.Tensor, ref: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over all pixels/channels."""
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int, sigma: float) -> list[float]:
    x = [i - (size - 1) / 2.0 for i in range(size)]
    g = [math.exp(-0.5 * (v / sigma) ** 2) for v in x]
    return [v / sum(g) for v in g]


def _blur(x: torch.Tensor, k: list[float]) -> torch.Tensor:
    """Separable Gaussian over the first two axes of ``x [H, W, C]``, zero
    padding, output the size of the input."""
    r = len(k) // 2
    h, w = x.shape[:2]
    xp = torch.nn.functional.pad(x, (0, 0, r, r, r, r))
    x = sum(kk * xp[i:i + h] for i, kk in enumerate(k))        # rows
    return sum(kk * x[:, i:i + w] for i, kk in enumerate(k))   # columns


def ssim(img: torch.Tensor, ref: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] (or [H, W]) image pair.

    Separable-Gaussian-window SSIM (Wang et al. 2004) with the standard
    K1=0.01 / K2=0.03 constants — the construction of the original 3DGS
    training loss.  Differentiable; use ``1 - ssim(...)`` as a loss.
    """
    if img.dim() == 2:
        img, ref = img[..., None], ref[..., None]
    img = img.to(torch.float32)
    ref = ref.to(torch.float32)
    k = _gaussian_kernel(kernel_size, sigma)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x, mu_y = _blur(img, k), _blur(ref, k)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = _blur(img * img, k) - mu_x2
    sig_y = _blur(ref * ref, k) - mu_y2
    sig_xy = _blur(img * ref, k) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    return torch.mean(num / den)


def d_ssim_l1_loss(img: torch.Tensor, ref: torch.Tensor,
                   ssim_weight: float = 0.2) -> torch.Tensor:
    """The 3DGS paper's training loss: (1-w) * L1 + w * (1 - SSIM)."""
    l1 = torch.mean(torch.abs(img - ref))
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(img, ref))

"""Untiled front-to-back alpha compositing via log-transmittance prefix sums
(counterpart of the JAX package's ``render/compositing.py``).

    C = sum_i T_i * alpha_i * c_i,   T_{i+1} = T_i * (1 - alpha_i),  T_0 = 1

Per-fragment semantics shared by every compositor of the port:

    G     = a dx^2 + 2 b dx dy + c dy^2       (conic quadratic form)
    alpha = opacity * exp(-0.5 G)
    alpha = 0        where G > 8, alpha < min_alpha or outside the rx/ry box
    alpha = min(alpha, 0.999)
"""

from __future__ import annotations

import torch

from ..constants import ALPHA_CLAMP, GAUSSIAN_CUTOFF


def splat_alphas(px, py, mean2d, conic, opacity, radius, min_alpha):
    """``[P]`` pixel centers x ``[C]`` splats -> ``[C, P]`` alphas."""
    dx = px[None, :] - mean2d[:, 0:1]
    dy = py[None, :] - mean2d[:, 1:2]
    g = (conic[:, 0:1] * dx * dx + 2.0 * conic[:, 1:2] * dx * dy
         + conic[:, 2:3] * dy * dy)
    alpha = opacity[:, None] * torch.exp(-0.5 * g)
    outside = ((g > GAUSSIAN_CUTOFF) | (alpha < min_alpha)
               | (torch.abs(dx) > radius[:, 0:1])
               | (torch.abs(dy) > radius[:, 1:2]))
    alpha = torch.where(outside, torch.zeros_like(alpha), alpha)
    return torch.clamp(alpha, max=ALPHA_CLAMP)


def composite_chunk(px, py, mean2d, conic, color, opacity, radius,
                    min_alpha, color_acc, trans):
    """Composite one chunk of C splats (front-to-back order) over P pixels:
    the updated (color_acc [P, K], trans [P])."""
    alpha = splat_alphas(px, py, mean2d, conic, opacity, radius,
                         min_alpha)                              # [C, P]
    log_omega = torch.log1p(-alpha)
    # exclusive prefix sum along the splats: log prod_{j<i} (1 - alpha_j)
    excl = torch.cumsum(log_omega, dim=0) - log_omega
    w = alpha * torch.exp(excl) * trans[None, :]
    color_acc = color_acc + w.T @ color
    trans = trans * torch.exp(torch.sum(log_omega, dim=0))
    return color_acc, trans


def composite_sorted(px, py, mean2d, conic, color, opacity, radius,
                     min_alpha, chunk_size: int = 128):
    """Composite depth-sorted splats over all pixels, ``chunk_size`` splats
    at a time (:func:`composite_chunk`).  ``color`` may carry any number
    of channels K.  Returns (color [P, K], trans [P])."""
    p = px.shape[0]
    k = color.shape[-1]
    color_acc = torch.zeros((p, k), dtype=torch.float32, device=px.device)
    trans = torch.ones((p,), dtype=torch.float32, device=px.device)
    for s in range(0, mean2d.shape[0], chunk_size):
        e = s + chunk_size
        color_acc, trans = composite_chunk(
            px, py, mean2d[s:e], conic[s:e], color[s:e], opacity[s:e],
            radius[s:e], min_alpha, color_acc, trans)
    return color_acc, trans


def pixel_grid(width: int, height: int, device):
    """Flat GL-oriented pixel centers of a full image, row 0 at the top
    (row r has y = height - (r + 0.5))."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = height - (torch.arange(height, dtype=torch.float32,
                                device=device) + 0.5)
    return xs.repeat(height), ys.repeat_interleave(width)

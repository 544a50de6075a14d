"""Loss library (port of tpu_splat/train/losses.py; reference
utils/loss_utils.py): L1, L2, PSNR, the edge-aware smoothness and SSIM (window 11, sigma 1.5,
C1 = 0.01^2, C2 = 0.03^2) as a same-padded depthwise convolution.

Images are channels-last [H, W, C] (or [B, H, W, C]), as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware second-order disparity smoothness (reference
    utils/loss_utils.py:51-58). disp [H,W] or [H,W,1], img [H,W,C],
    channels-last."""
    if disp.dim() == 3:
        disp = disp[..., 0]
    gx = torch.abs(disp[1:-1, :-2] + disp[1:-1, 2:] - 2 * disp[1:-1, 1:-1])
    gy = torch.abs(disp[:-2, 1:-1] + disp[2:, 1:-1] - 2 * disp[1:-1, 1:-1])
    ix = torch.mean(torch.abs(img[1:-1, :-2] - img[1:-1, 2:]), dim=-1) * 0.5
    iy = torch.mean(torch.abs(img[:-2, 1:-1] - img[2:, 1:-1]), dim=-1) * 0.5
    return torch.mean(gx * torch.exp(-ix)) + torch.mean(gy * torch.exp(-iy))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / torch.sum(g)
    return torch.outer(g, g)  # [size, size]


def _depthwise_conv(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C], window [k, k] -> same-padded depthwise conv."""
    c = img.shape[-1]
    k = window.shape[0]
    x = img.permute(0, 3, 1, 2)
    w = window[None, None].expand(c, 1, k, k)
    return F.conv2d(x, w, padding=k // 2, groups=c).permute(0, 2, 3, 1)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    return_map: bool = False,
):
    """Mean SSIM (or the map) over channels-last images [H,W,C] / [B,H,W,C]."""
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    w = _gaussian_window(window_size, sigma, img1.device)
    mu1 = _depthwise_conv(img1, w)
    mu2 = _depthwise_conv(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_conv(img1 * img1, w) - mu1_sq
    sigma2_sq = _depthwise_conv(img2 * img2, w) - mu2_sq
    sigma12 = _depthwise_conv(img1 * img2, w) - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    if return_map:
        return ssim_map[0] if squeeze else ssim_map
    return torch.mean(ssim_map)

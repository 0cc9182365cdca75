"""Image quality metrics: MSE, RMSE, PSNR, windowed SSIM (+optional LPIPS).

Torch counterpart of `gaussiansplattingregistration_tpu/ops/metrics.py`:
SSIM uses the 11x11 Gaussian window (sigma 1.5) applied per channel with a
same-padded depthwise convolution; PSNR is 20 log10(1/sqrt(mse)). LPIPS
(`ops/lpips.py`) comes as a callable from `lpips_fn`, which `all_metrics`
takes, as in JAX.

On the card a float32 convolution goes through cuDNN, in TF32 unless
`torch.backends.cudnn.allow_tf32` is off. The package turns it off at import
(`__init__.py`, its one TF32 policy), so the blur and its autograd backward
run in full float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gaussiansplattingregistration_tpu_torch.utils import profiling


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return torch.mean((img1 - img2) ** 2)


def rmse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(mse(img1, img2))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse(img1, img2), 1e-12)))


def _gaussian_window(window_size: int, sigma: float, device) -> torch.Tensor:
    xs = torch.arange(window_size, dtype=torch.float32, device=device) - window_size // 2
    g = torch.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    g = g / torch.sum(g)
    return g[:, None] * g[None, :]  # [W, W]


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    size_average: bool = True,
) -> torch.Tensor:
    """Windowed SSIM; images are [H, W, C] (or [C, H, W] matching shapes).
    C1 = 0.01^2, C2 = 0.03^2, as the JAX package. Its forward is the span
    `metrics.ssim` (`utils/profiling.py`)."""
    with profiling.span("metrics.ssim"):
        return _ssim(img1, img2, window_size, size_average)


def _ssim(img1, img2, window_size: int, size_average: bool) -> torch.Tensor:
    if img1.ndim == 3 and img1.shape[-1] in (1, 3):
        img1 = img1.permute(2, 0, 1)
        img2 = img2.permute(2, 0, 1)
    c = img1.shape[0]
    window = _gaussian_window(window_size, 1.5, img1.device).to(img1.dtype)
    kernel = window.expand(c, 1, window_size, window_size)

    def blur(x):
        """Same-padded depthwise blur of a [C, H, W] image."""
        return F.conv2d(x[None], kernel, padding=window_size // 2, groups=c)[0]

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2

    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map) if size_average else torch.mean(ssim_map, dim=(1, 2))


def lpips_fn(device=None):
    """The LPIPS callable (AlexNet; see ops/lpips.py for the weight order)
    with its weights on `device` (default `cuda`). Its `source` attribute
    names the live weights."""
    from gaussiansplattingregistration_tpu_torch.ops import lpips as lpips_ops

    params = lpips_ops.default_params(device)

    def run(img1, img2):
        return float(lpips_ops.lpips(img1, img2, params))

    run.source = params.source  # type: ignore[attr-defined]
    return run


def all_metrics(img1: torch.Tensor, img2: torch.Tensor, lpips_callable=None) -> dict:
    """The evaluator's metric dict (MSE/RMSE/SSIM/PSNR [+LPIPS])."""
    m = float(mse(img1, img2))
    out = {
        "mse": m,
        "rmse": math.sqrt(m),
        "ssim": float(ssim(img1, img2)),
        "psnr": float(psnr(img1, img2)),
    }
    if lpips_callable is not None:
        out["lpips"] = float(lpips_callable(img1, img2))
    return out

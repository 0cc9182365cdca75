"""LPIPS perceptual metric (AlexNet backbone + linear heads).

Torch counterpart of `gaussiansplattingregistration_tpu/ops/lpips.py`:

    d(x, y) = sum_l mean_hw || w_l * (norm(f_l(x)) - norm(f_l(y))) ||^2

with f_l the 5 AlexNet ReLU taps (`F.conv2d`, `F.max_pool2d`), norm()
channel-unit-normalization, and w_l >= 0 learned 1x1 heads, as
`lpips.LPIPS(net='alex')` computes it. The package turns TF32 off at import,
so the convolutions run in float32 on the card.

Weights resolve in the JAX package's order:

1. an explicit npz path (or the `GSR_LPIPS_WEIGHTS` env var) in the layout
   `save_weights` writes, which is the JAX package's: weights cross between
   the two packages through it;
2. the torch `lpips` package, when it is installed, converted;
3. the deterministic random-feature fallback: numpy-seeded He-init convs
   and uniform heads, the same bits as the JAX package's. Its values are
   not comparable to published trained-LPIPS numbers; `LPIPSParams.source`
   says which weights are live, and the evaluation log records it.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gaussiansplattingregistration_tpu_torch.utils.device import resolve_device

# AlexNet feature stack (torchvision layout): (out_ch, in_ch, k, stride, pad),
# with 3x3/2 max-pools after stages 1 and 2.
_CONVS = (
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)

# lpips.ScalingLayer constants (input in [-1, 1]).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_RANDOM_SEED = 1834579


@dataclasses.dataclass(frozen=True)
class LPIPSParams:
    """conv{i}_w [O,I,K,K], conv{i}_b [O], head{i} [C_i] (non-negative)."""

    tensors: Dict[str, torch.Tensor]
    source: str = "random"

    def to(self, device) -> "LPIPSParams":
        return LPIPSParams({k: v.to(device) for k, v in self.tensors.items()}, self.source)


def _random_arrays() -> Dict[str, np.ndarray]:
    """He-init backbone + uniform heads from numpy's generator, in the JAX
    package's draw order."""
    rng = np.random.default_rng(_RANDOM_SEED)
    t: Dict[str, np.ndarray] = {}
    for i, (o, c, k, _, _) in enumerate(_CONVS):
        t[f"conv{i}_w"] = rng.normal(0.0, np.sqrt(2.0 / (c * k * k)),
                                     size=(o, c, k, k)).astype(np.float32)
        t[f"conv{i}_b"] = np.zeros((o,), np.float32)
        t[f"head{i}"] = np.full((o,), 1.0 / o, np.float32)
    return t


def _params(arrays: Dict[str, np.ndarray], source: str, device) -> LPIPSParams:
    return LPIPSParams({k: torch.as_tensor(np.asarray(v), device=device)
                        for k, v in arrays.items()}, source)


def save_weights(params: LPIPSParams, path: str) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.tensors.items()})


def load_weights(path: str, device=None) -> LPIPSParams:
    """Weights from an npz (the JAX package's layout) on `device` (default
    `cuda`)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    for i, (o, c, k, _, _) in enumerate(_CONVS):
        if arrays[f"conv{i}_w"].shape != (o, c, k, k):
            raise ValueError(f"conv{i}_w shape {arrays[f'conv{i}_w'].shape}")
    return _params(arrays, f"npz:{os.path.basename(path)}", resolve_device(device))


def weights_from_torch(device=None) -> Optional[LPIPSParams]:
    """torchvision AlexNet + lpips linear heads, when the `lpips` package
    is importable (weight source #2); None otherwise."""
    try:
        import lpips as lpips_pkg  # type: ignore
    except ImportError:
        return None
    net = lpips_pkg.LPIPS(net="alex")
    modules = [m for s in (net.net.slice1, net.net.slice2, net.net.slice3,
                           net.net.slice4, net.net.slice5) for m in s]
    convs = [m for m in modules if isinstance(m, torch.nn.Conv2d)]
    t: Dict[str, np.ndarray] = {}
    for i, m in enumerate(convs):
        t[f"conv{i}_w"] = m.weight.detach().numpy()
        t[f"conv{i}_b"] = m.bias.detach().numpy()
    for i, lin in enumerate(net.lins):
        t[f"head{i}"] = lin.model[-1].weight.detach().numpy().reshape(-1)
    return _params(t, "torch", resolve_device(device))


@functools.lru_cache(maxsize=1)
def _default_host_params() -> LPIPSParams:
    path = os.environ.get("GSR_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path):
        return load_weights(path, device="cpu")
    p = weights_from_torch(device="cpu")
    if p is not None:
        return p
    return _params(_random_arrays(), "random", torch.device("cpu"))


def default_params(device=None) -> LPIPSParams:
    """The weights by the priority order in the module docstring, on
    `device` (default `cuda`); resolved once per process."""
    return _default_host_params().to(resolve_device(device))


def _features(x: torch.Tensor, params: LPIPSParams):
    """x: [N, 3, H, W] in [-1, 1] -> list of 5 ReLU taps."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    taps = []
    for i, (_, _, _, s, p) in enumerate(_CONVS):
        x = F.relu(F.conv2d(x, params.tensors[f"conv{i}_w"], params.tensors[f"conv{i}_b"],
                            stride=s, padding=p))
        taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)


def lpips_pair(img1: torch.Tensor, img2: torch.Tensor, params: LPIPSParams) -> torch.Tensor:
    """LPIPS distance between two [H, W, 3] images in [0, 1]."""

    def prep(x):
        return x.to(torch.float32).permute(2, 0, 1)[None] * 2.0 - 1.0

    total = torch.zeros((), device=img1.device)
    for i, (a, b) in enumerate(zip(_features(prep(img1), params), _features(prep(img2), params))):
        d = _unit_normalize(a) - _unit_normalize(b)
        head = torch.clamp_min(params.tensors[f"head{i}"], 0.0)
        total = total + torch.mean(torch.einsum("nchw,c->nhw", d * d, head))
    return total


def lpips(img1, img2, params: Optional[LPIPSParams] = None) -> torch.Tensor:
    """LPIPS(alex) distance of [H, W, 3] images in [0, 1], on the images'
    device; the default weights unless `params` is given."""
    img1, img2 = torch.as_tensor(img1), torch.as_tensor(img2)
    if params is None:
        params = default_params(img1.device)
    return lpips_pair(img1, img2.to(img1.device), params)

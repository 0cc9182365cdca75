"""Checkpoint/resume of registration state.

Torch counterpart of `gaussiansplattingregistration_tpu/utils/checkpoint.py`,
with the same `.npz` + `.json` layout and keys: `transformation`, `twist`,
`loss_history`, `mix{i}.{xyz,colors,opacities,covariance,features}` and
`opt_state.{i}`. A checkpoint written by either package loads in the other
for every key but `opt_state`, whose leaf order each package defines for
its own optimizer state.

Here `opt_state` is any nested dict / list / tuple of tensors, arrays or
numbers. Its leaves are flattened in a fixed order (dict keys sorted,
sequences in order) and restored against a template of the same structure:
a tensor leaf comes back as a tensor of the template leaf's dtype and
device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple, in the fixed order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _restore(template, leaves):
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(template, dict):
        return {k: _restore(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        values = [_restore(v, leaves) for v in template]
        return type(template)(*values) if hasattr(template, "_fields") else type(template)(values)
    value = next(leaves)
    if torch.is_tensor(template):
        return torch.as_tensor(value, dtype=template.dtype, device=template.device)
    return value


def save_checkpoint(
    path: str,
    transformation,
    *,
    twist=None,
    opt_state: Any = None,
    loss_history: Optional[List[float]] = None,
    mixture_levels: Optional[list] = None,
    metadata: Optional[dict] = None,
) -> None:
    """Write <path>.npz (arrays) + <path>.json (manifest)."""
    arrays: Dict[str, np.ndarray] = {"transformation": _host(transformation)}
    if twist is not None:
        arrays["twist"] = _host(twist)
    if opt_state is not None:
        for i, leaf in enumerate(_leaves(opt_state)):
            arrays[f"opt_state.{i}"] = _host(leaf)
    if loss_history:
        arrays["loss_history"] = np.asarray(loss_history, np.float64)
    for i, lvl in enumerate(mixture_levels or []):
        for name in ("xyz", "colors", "opacities", "covariance", "features"):
            arrays[f"mix{i}.{name}"] = _host(getattr(lvl, name))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path + ".npz", **arrays)
    manifest = {
        "keys": sorted(arrays.keys()),
        "num_mixture_levels": len(mixture_levels or []),
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)


def load_checkpoint(path: str, opt_state_template: Any = None) -> dict:
    """Load a checkpoint; returns a dict with transformation, twist,
    loss_history, mixture_levels (the port's `hem.MixtureLevel`), metadata
    and, given a template of its structure, the restored opt_state."""
    from gaussiansplattingregistration_tpu_torch.ops.hem import MixtureLevel

    with np.load(path + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    with open(path + ".json") as f:
        manifest = json.load(f)

    out: dict = {
        "transformation": arrays["transformation"],
        "twist": arrays.get("twist"),
        "loss_history": arrays.get("loss_history", np.zeros(0)).tolist(),
        "metadata": manifest.get("metadata", {}),
        "mixture_levels": [
            MixtureLevel(**{name: arrays[f"mix{i}.{name}"] for name in
                            ("xyz", "colors", "opacities", "covariance", "features")})
            for i in range(manifest.get("num_mixture_levels", 0))
        ],
    }
    if opt_state_template is not None:
        n = len(_leaves(opt_state_template))
        out["opt_state"] = _restore(opt_state_template,
                                    iter(arrays[f"opt_state.{i}"] for i in range(n)))
    return out

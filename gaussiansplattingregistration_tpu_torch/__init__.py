"""PyTorch/CUDA port of the Gaussian Splatting registration framework.

The JAX package (`gaussiansplattingregistration_tpu`) is the reference; this
package keeps its module paths and public names so each counterpart is easy
to find. Plain tensor code is PyTorch; the rasterizer's tile compositor is a
hand-written CUDA kernel (`csrc/composite_fwd.cu`) built at first use.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
card and no explicit CPU request they raise instead of running on the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of the JAX package's forced f32 matmuls: TF32 keeps ~3 decimal
# digits, far below the 1e-3 accuracy contract of the geometry paths.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from gaussiansplattingregistration_tpu_torch.models.gaussian_cloud import GaussianCloud  # noqa: E402
from gaussiansplattingregistration_tpu_torch.models.camera import Camera  # noqa: E402

__all__ = ["GaussianCloud", "Camera", "__version__"]

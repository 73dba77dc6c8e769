"""linpde_gp_tpu_torch: the PyTorch/CUDA port of linpde_gp_tpu.

The JAX package ``linpde_gp_tpu`` stays the reference; this package
mirrors its module paths and never imports JAX.  The slices ported so far
are gram-free GP conditioning on operator observations
(:class:`models.iterative.IterativeGPRegressor`, from a
:class:`models.gp.GaussianProcess` prior and an operator of
``ops.diffops``) through the symbolic layer that derives closed-form
kernel specs (``ops/kernels``, ``ops/diffops``, ``ops/transforms``), with
hand-written CUDA kernels for Gram assembly and the Gram matvec
(``csrc/gram.cuh``) and the banded matvec of compactly supported kernels
(``csrc/banded.cuh``), compiled per kernel-spec structure at first use
(``ops/_cuda.py``).
"""

import torch

from .config import MODES, config
from .models.gp import GaussianProcess
from .models.iterative import IterativeGPRegressor

# Full float32 matmuls (the Nyström GEMMs and the Woodbury apply): TF32
# keeps ~3 decimal digits and breaks CG the way bf16 did on the TPU.
# Both are torch's defaults; they are stated here so nothing relies on it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__all__ = ["GaussianProcess", "IterativeGPRegressor", "MODES", "config"]

"""Pore-model tables as device tensors.

Replaces the JAX runner's ``_nuc_dev_tables`` / ``_cpg_dev_tables``
(``f5c_tpu/pipeline/runner.py:786-795``, ``2208-2217``): the parameters
stay the JAX package's NumPy ``PoreModel`` (``f5c_tpu.models``); only
their device copies are made here.
"""

from __future__ import annotations

import numpy as np
import torch

from f5c_tpu.models import PoreModel, builtin_model  # noqa: F401 (re-export)

TABLE_NAMES = ("level_mean", "level_stdv", "level_log_stdv")


def tables_from_model(model: PoreModel,
                      device: torch.device) -> dict[str, torch.Tensor]:
    """f32 tensors ``level_mean``, ``level_stdv``, ``level_log_stdv`` on
    ``device``, indexed by k-mer rank, byte-identical to the model's
    NumPy tables."""
    return {name: torch.as_tensor(
        np.ascontiguousarray(getattr(model, name), dtype=np.float32),
        device=device) for name in TABLE_NAMES}

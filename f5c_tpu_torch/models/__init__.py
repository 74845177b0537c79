"""Pore models (``pore_model.py``, the port's copy of
``f5c_tpu/models/pore_model.py``, with its built-in tables in ``data/``)
and their device copies.

``tables_from_model`` replaces the JAX runner's ``_nuc_dev_tables`` /
``_cpg_dev_tables`` (``f5c_tpu/pipeline/runner.py:786-795``,
``2208-2217``): the parameters stay the NumPy ``PoreModel``; only their
device copies are made here.
"""

from __future__ import annotations

import numpy as np
import torch

from .pore_model import (BUILTIN_MODELS, PoreModel, builtin_model,
                         kmer_ranks_dna, kmer_ranks_meth, load_model_file)

__all__ = ["BUILTIN_MODELS", "PoreModel", "TABLE_NAMES", "builtin_model",
           "kmer_ranks_dna", "kmer_ranks_meth", "load_model_file",
           "tables_from_model"]

TABLE_NAMES = ("level_mean", "level_stdv", "level_log_stdv")


def tables_from_model(model: PoreModel,
                      device: torch.device) -> dict[str, torch.Tensor]:
    """f32 tensors ``level_mean``, ``level_stdv``, ``level_log_stdv`` on
    ``device``, indexed by k-mer rank, byte-identical to the model's
    NumPy tables."""
    return {name: torch.as_tensor(
        np.ascontiguousarray(getattr(model, name), dtype=np.float32),
        device=device) for name in TABLE_NAMES}

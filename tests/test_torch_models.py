"""tables_from_model carries the JAX package's NumPy model tables into
the port's tensors byte for byte."""

import numpy as np
import pytest
import torch

from f5c_tpu.models import builtin_model
from f5c_tpu_torch.models import TABLE_NAMES, tables_from_model


@pytest.mark.parametrize("model_id", ["dna_r9_nucleotide", "dna_r9_cpg",
                                      "rna_r9_nucleotide",
                                      "rna004_nucleotide"])
def test_tables_match_numpy_model(model_id):
    model = builtin_model(model_id)
    tables = tables_from_model(model, torch.device("cpu"))
    assert set(tables) == set(TABLE_NAMES)
    for name in TABLE_NAMES:
        want = np.ascontiguousarray(getattr(model, name))
        got = tables[name].numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name

"""The port's copy of the pore models (f5c_tpu_torch/models) gives the JAX
package's models byte for byte, and tables_from_model carries them into
the port's tensors byte for byte."""

import numpy as np
import pytest
import torch

from f5c_tpu.models import builtin_model as jax_builtin_model
from f5c_tpu_torch.models import TABLE_NAMES, builtin_model, tables_from_model


@pytest.mark.parametrize("model_id", ["dna_r9_nucleotide", "dna_r9_cpg",
                                      "rna_r9_nucleotide",
                                      "rna004_nucleotide"])
def test_tables_match_numpy_model(model_id):
    model = builtin_model(model_id)
    want_model = jax_builtin_model(model_id)
    assert (model.k, model.alphabet, model.num_kmers) == (
        want_model.k, want_model.alphabet, want_model.num_kmers)
    tables = tables_from_model(model, torch.device("cpu"))
    assert set(tables) == set(TABLE_NAMES)
    for name in TABLE_NAMES:
        want = np.ascontiguousarray(getattr(want_model, name))
        assert getattr(model, name).tobytes() == want.tobytes(), name
        got = tables[name].numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name

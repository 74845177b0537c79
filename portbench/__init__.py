"""The benchmark of ``f5c_tpu_torch``: see README.md."""

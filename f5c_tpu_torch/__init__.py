"""f5c-tpu on PyTorch and CUDA: the call-methylation path on one NVIDIA GPU.

A port of the JAX package ``f5c_tpu`` (which stays the reference).  Host
layers that import no JAX -- I/O, pore models, the native C++ host library,
the NumPy oracles, methylation group collection and the TSV writer -- are
imported from ``f5c_tpu``, not copied.  Everything that touched a JAX
device is re-implemented here:

- ``f5c_tpu_torch.backend``   device resolution and the toolchain probe
- ``f5c_tpu_torch.models``    model tables as device tensors
- ``f5c_tpu_torch.ops``       plain PyTorch versions and hand-written CUDA
                               kernels (``csrc/*.cu``) for ABEA and the
                               profile-HMM forward pass
- ``f5c_tpu_torch.pipeline``  the call-methylation runtime
- ``f5c_tpu_torch.cli``       ``python -m f5c_tpu_torch.cli call-methylation``

The package never imports ``jax``.
"""

__version__ = "0.1.0"

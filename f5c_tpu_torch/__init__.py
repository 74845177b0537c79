"""f5c-tpu on PyTorch and CUDA: the call-methylation path on NVIDIA GPUs.

A port of the JAX package ``f5c_tpu`` (which stays the reference).  The
port stands alone: it imports nothing of ``f5c_tpu``.  The host layers it
runs are copies of the JAX package's, under the same module names --
``constants``, ``io``, ``models`` (with the built-in tables), ``native``
(the C++ host library, built at first use into
``build/f5c_tpu_torch/native/``), ``profiles``, ``pipeline.writer`` and
``pipeline.methylation`` -- and everything that touched a JAX device is
re-implemented here:

- ``f5c_tpu_torch.backend``   device resolution and the toolchain probe
- ``f5c_tpu_torch.models``    pore models and their tables as device
                               tensors
- ``f5c_tpu_torch.ops``       plain PyTorch versions and hand-written CUDA
                               kernels (``csrc/*.cu``) for ABEA and the
                               profile-HMM forward pass
- ``f5c_tpu_torch.pipeline``  the call-methylation runtime
- ``f5c_tpu_torch.parallel``  dispatches dealt over several devices
                               (``mesh``) and ``--dist`` over processes
                               (``distributed``, a gloo group)
- ``f5c_tpu_torch.cli``       ``python -m f5c_tpu_torch.cli call-methylation``

The package never imports ``jax``.
"""

__version__ = "0.1.0"

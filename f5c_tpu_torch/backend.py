"""Device resolution, the toolchain probe, and host <-> device copies.

The port keeps no global device state: the entry point resolves one
``torch.device`` here and passes it down.  Counterpart of the JAX
package's platform selection (``f5c_tpu/cli.py:_make_pipeline`` and
``Pipeline._use_pallas``).
"""

from __future__ import annotations

import importlib.util

import numpy as np
import torch


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` -> the current CUDA device (an error when there is no
    card: the port never falls back to the host silently); ``"cpu"`` ->
    the host, where every op runs its plain PyTorch version."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown device {name!r} (expected 'cuda' or 'cpu')")


def canonical_device(device) -> torch.device:
    """``device`` with its index: an unindexed ``cuda`` is the calling
    thread's current card, so that two names of one card compare equal
    (without a card it stays as named, and a launch on it raises)."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and torch.cuda.is_available()):
        return torch.device("cuda", torch.cuda.current_device())
    return device


def h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; a CUDA upload goes through
    pinned memory without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class HostCopy:
    """Device tensors (all on one device) on their way to host memory: the
    copy into pinned buffers is queued on that device's current stream;
    ``wait()`` blocks until it has landed and returns NumPy arrays."""

    def __init__(self, tensors):
        if tensors[0].is_cuda:
            dev = tensors[0].device
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(dev))
        else:
            self._host = list(tensors)
            self._done = None

    def wait(self) -> list[np.ndarray]:
        if self._done is not None:
            self._done.synchronize()
        return [h.numpy() for h in self._host]


def probe() -> dict:
    """What this process can run: torch and CUDA versions, the card, the
    CUDA compiler that builds ``csrc/``, and whether ``triton`` imports."""
    from .ops._build import find_nvcc

    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "nvcc": find_nvcc(),
        "triton": importlib.util.find_spec("triton") is not None,
    }
    if info["cuda_available"]:
        props = torch.cuda.get_device_properties(0)
        info.update(device_name=props.name,
                    sm_count=props.multi_processor_count,
                    capability=f"{props.major}.{props.minor}",
                    device_count=torch.cuda.device_count())
    return info

"""Build ``csrc/*.cu`` with nvcc into one shared library and load it.

The kernels have a plain C interface and are loaded with ``ctypes``: no
PyTorch headers are compiled, so a build takes seconds.  Each ``.cu`` is
compiled by its own nvcc process, all started together, and the objects
are linked into one library.  It is built at first use into
``build/f5c_tpu_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources, the headers (``*.cuh``) and the flags, and reused
while none of them changes.  Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "f5c_tpu_torch")

# --fmad=false: no FMA contraction, so the ABEA fill is bit-identical to
# the reference; never --use_fast_math (IEEE division and accurate
# transcendentals are part of the contract)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_longlong
# C entry points: every pointer and the stream as void*, sizes as int
# (a reference concat's length in codes and a launch's events as 64-bit
# ints)
_SIGNATURES = {
    "f5c_abea_fill": [_vp] * 14 + [_int] * 4 + [_vp],
    "f5c_abea_fill_routed": [_vp] * 15 + [_int] * 4 + [_vp],
    "f5c_abea_division_probe": [_vp] * 6 + [_int] + [_vp],
    "f5c_abea_ranks": [_vp] * 4 + [_int] * 2 + [_vp],
    "f5c_abea_walk": [_vp] * 9 + [_int] * 2 + [_vp],
    "f5c_abea_walk_tiled": [_vp] * 15 + [_int] * 8 + [_vp],
    "f5c_hmm_forward_meta": [_vp] * 9 + [_i64] + [_int] * 7 + [_vp],
    "f5c_hmm_window_ranks": [_vp] * 4 + [_i64] + [_int] * 3 + [_vp],
    "f5c_abea_fill_window": [_vp] * 15 + [_int] * 7 + [_vp],
    "f5c_abea_fill_window_routed": [_vp] * 16 + [_int] * 7 + [_vp],
    "f5c_abea_walk_window": [_vp] * 5 + [_int] * 4 + [_vp],
    "f5c_viterbi_rounds": [_vp] * 12 + [_int] * 4 + [_vp],
    "f5c_viterbi_division_probe": [_vp] * 4 + [_int] + [_vp],
    "f5c_events_sums": [_vp] * 9 + [_int] * 3 + [_vp],
    "f5c_events_peaks": [_vp] * 6 + [_int] * 4 + [_vp],
    "f5c_events_assemble": [_vp] * 9 + [_int, _i64] + [_vp],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}
# while a caller holds a list here, the wrappers of K8, K9 and the walks
# (K4, K10) append a (start, stop) pair of CUDA events around each of
# their launches: the kernels' own time, apart from their wrappers' host
# work (chip_smoke.py times them so)
launch_spans = None


def find_nvcc() -> str | None:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.isfile(cand) else None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + _headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(_build())
        return _lib


def _build() -> str:
    sources = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(sources))
    so_path = os.path.join(out_dir, "libf5c_tpu_torch.so")
    if os.path.isfile(so_path):
        build_info.update(path=so_path, seconds=0.0, cached=True)
        return so_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "f5c_tpu_torch/csrc need the CUDA toolkit")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    tmp = f"{so_path}.{tag}"
    t0 = time.time()
    objs = [os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
            for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    log = "".join(out for out, _ in outs)
    rc = next((code for _, code in outs if code != 0), 0)
    if rc == 0:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        log += link.stdout + link.stderr
        rc = link.returncode
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
    os.replace(tmp, so_path)
    build_info.update(path=so_path, seconds=time.time() - t0, cached=False,
                      log=log)
    return so_path


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.f5c_error_string.argtypes = [ctypes.c_int]
    lib.f5c_error_string.restype = ctypes.c_char_p
    return lib


def check_tensor(name, t, dtype, ndim, device) -> None:
    """A wrapper's argument check: raise unless ``t`` is a contiguous
    tensor of ``dtype`` with ``ndim`` dims on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


@contextlib.contextmanager
def device_guard(device):
    """Make ``device`` the calling thread's current CUDA device for a
    launch.  The C entry points launch on the runtime's current device,
    and the functions they call (``cudaFuncSetAttribute``,
    ``cudaGetDevice``) act on it too, so every wrapper enters this guard
    around its launch: the tensors' device, not whatever device the
    caller left current.  On a CPU device it does nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        yield


def stream_handle(device) -> int:
    """torch's current CUDA stream on ``device``, as the C entry points
    take it."""
    return torch.cuda.current_stream(device).cuda_stream


def span_start(device):
    """A CUDA event recorded before a launch on ``device``'s current
    stream, or None when no caller records spans."""
    if launch_spans is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def span_stop(start, device) -> None:
    """Close the span that ``span_start`` opened (None: nothing)."""
    if start is not None:
        stop = torch.cuda.Event(enable_timing=True)
        stop.record(torch.cuda.current_stream(device))
        launch_spans.append((start, stop))


def check_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise when a C entry point reports a CUDA error (it returns
    ``cudaGetLastError()`` right after its launch)."""
    if err != 0:
        msg = lib.f5c_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")

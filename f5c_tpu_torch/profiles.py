"""Machine parameter presets (-x), mirroring the reference's profiles
(src/profiles.h:14-220, src/profiles.c:51-117).

Each preset sets the batch geometry (K reads / B bases), host worker
count, I/O process count, and the ultra-long read threshold.  The
reference's CUDA memory knobs (max-lf / avg-epk / max-epk) have no TPU
equivalent — the TPU path length-buckets and streams batches instead of
partitioning reads between CPU and GPU — so they are accepted and
recorded but unused.  A profile name that is not in the table is read as
a file of 7 numbers (max-lf avg-epk max-epk K B t ultra-thresh), like
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Profile:
    max_lf: float
    avg_epk: float
    max_epk: float
    batch_size: int           # K
    batch_size_bases: int     # B
    num_thread: int
    ultra_thresh: int
    num_iop: int


PROFILES = {
    "jetson-nano": Profile(3.0, 2.0, 5.0, 200, 1_400_000, 4, 100_000, 1),
    "jetson-tx2": Profile(3.0, 2.0, 5.0, 512, 2_350_000, 6, 100_000, 1),
    "jetson-xavier": Profile(3.0, 2.0, 6.25, 1024, 4_700_000, 8, 100_000, 2),
    "laptop-low": Profile(5.0, 2.0, 5.0, 256, 1_500_000, 4, 100_000, 1),
    "laptop-mid": Profile(5.0, 2.0, 5.0, 350, 2_000_000, 8, 100_000, 2),
    "laptop-high": Profile(5.0, 2.0, 5.0, 512, 2_500_000, 12, 100_000, 2),
    "desktop-low": Profile(5.0, 2.0, 5.0, 512, 5_000_000, 8, 100_000, 2),
    "desktop-mid": Profile(5.0, 2.0, 5.0, 768, 6_250_000, 12, 100_000, 4),
    "desktop-high": Profile(5.0, 2.0, 5.0, 1024, 7_500_000, 16, 100_000, 6),
    "hpc-low": Profile(5.0, 2.0, 5.0, 1024, 10_000_000, 32, 100_000, 64),
    "hpc-mid": Profile(5.0, 2.0, 5.0, 2048, 20_000_000, 48, 100_000, 64),
    "hpc-high": Profile(5.0, 2.0, 5.0, 2560, 25_000_000, 64, 100_000, 64),
    "hpc-cpu": Profile(5.0, 2.0, 5.0, 4096, 50_000_000, 32, 100_000, 32),
    "hpc-gpu": Profile(5.0, 2.0, 5.0, 1024, 10_000_000, 32, 100_000, 32),
    "nci-gadi": Profile(5.0, 2.0, 5.0, 2048, 20_000_000, 12, 100_000, 64),
    # TPU-native presets: one chip streams large batches; the host side
    # is the native C++ runtime, so worker count tracks host cores
    "tpu": Profile(5.0, 2.0, 5.0, 512, 5_000_000, 1, 100_000, 1),
    "tpu-pod-host": Profile(5.0, 2.0, 5.0, 2048, 20_000_000, 8, 100_000, 8),
}
# aliases (profiles.c:62-77)
PROFILES["laptop"] = PROFILES["laptop-mid"]
PROFILES["desktop"] = PROFILES["desktop-mid"]
PROFILES["hpc"] = PROFILES["hpc-mid"]


def load_profile(name: str) -> Profile:
    """Named preset, or a file of 7 whitespace-separated numbers."""
    if name in PROFILES:
        return PROFILES[name]
    with open(name) as f:
        vals = f.read().split()
    if len(vals) < 7:
        raise ValueError(f"malformed profile file {name}: need 7 values "
                         "(max-lf avg-epk max-epk K B t ultra-thresh)")
    return Profile(float(vals[0]), float(vals[1]), float(vals[2]),
                   int(vals[3]), int(float(vals[4])), int(vals[5]),
                   int(float(vals[6])), num_iop=1)


def apply_profile(opt, name: str):
    """Apply preset to an Options instance (set_opt_profile)."""
    p = load_profile(name)
    opt.batch_reads = p.batch_size
    opt.batch_bases = p.batch_size_bases
    opt.num_proc = max(1, p.num_thread)
    opt.ultra_thresh = p.ultra_thresh
    return p

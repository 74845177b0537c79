"""Frozen copy of f5c_tpu/constants.py at commit 5f95a86, part of the
benchmark's plain reference; imports rewritten to stand alone.

Algorithm constants shared across the framework.

Values mirror the reference implementation's compile-time constants so that
outputs are comparable within the published float tolerance
(|x - truth| <= 0.1*|truth| + 0.02).  Reference locations cited per constant
(paths relative to the f5c repo).
"""

# --- ABEA (adaptive banded event alignment) ------------------------------
# f5c.h:34 — DP band width.  On TPU we compute over a 128-lane vector and
# mask the final 28 lanes, so the numerics match bandwidth=100 exactly.
ALN_BANDWIDTH = 100
# Pallas/VPU lane width the band is padded to.
BAND_LANES = 128

# align.c:199-216 — QC + transition parameters.
ABEA_MIN_AVG_LOG_EMISSION = -5.0
ABEA_MAX_GAP_THRESHOLD = 50
ABEA_EPSILON_SKIP = 1e-10     # p_skip
ABEA_LP_TRIM_P = 0.01         # p(trim) per trimmed event

# f5cmisc.h:16-18 — read-level QC thresholds.
MIN_CALIBRATION_VAR = 2.5
MAX_EVENT_TO_BP_RATIO = 20
AVG_EVENTS_PER_KMER_MAX = 15.0
MAX_EVENTS_PER_BASE = 5.0     # f5c.c:798 — post-scaling QC

# --- Event detection (events.c:52-63, scrappie defaults) ------------------
DNA_WINDOW1, DNA_WINDOW2 = 3, 6
DNA_THRESHOLD1, DNA_THRESHOLD2 = 1.4, 9.0
DNA_PEAK_HEIGHT = 0.2
RNA_WINDOW1, RNA_WINDOW2 = 7, 14
RNA_THRESHOLD1, RNA_THRESHOLD2 = 2.5, 9.0
RNA_PEAK_HEIGHT = 1.0

# --- Profile HMM (hmm.c:20-21, 261-272) -----------------------------------
TRANS_START_TO_CLIP = 0.5
TRANS_CLIP_SELF = 0.9
HMM_P_SKIP = 0.0025
HMM_P_BAD = 0.001
HMM_P_SKIP_SELF = 0.3
HMM_BACKGROUND_EMISSION = -3.0
# f5cmisc.h:40-41 — hmm_flags bits
HAF_ALLOW_PRE_CLIP = 1
HAF_ALLOW_POST_CLIP = 2

# --- Methylation calling (meth.c:473-612) ----------------------------------
METH_MIN_SEPARATION = 10      # CpG group batching distance
METH_MAX_GROUP_SPAN = 200
METH_MIN_EVENT_SPAN = 10      # |e2-e1| must exceed this

# --- Batch defaults (f5c.c:1174-1207) --------------------------------------
DEFAULT_BATCH_READS = 512            # -K
DEFAULT_BATCH_BASES = 5 * 1000 * 1000  # -B (CPU default; 2M for GPU)
DEFAULT_MIN_MAPQ = 20
DEFAULT_ULTRA_THRESH = 100 * 1000
DEFAULT_MIN_EVENTS_TO_RESCALE = 200

# --- Read status flags (f5c.h:66-68) ---------------------------------------
FAILED_CALIBRATION = 0x1
FAILED_ALIGNMENT = 0x2
FAILED_QUALITY_CHK = 0x4

# --- Model limits (f5c.h:30-32) ---------------------------------------------
MAX_KMER_SIZE = 9
MAX_NUM_KMER = 262144          # 4^9
MAX_NUM_KMER_METH = 1953125    # 5^9

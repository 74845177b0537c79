"""Native host runtime bindings (ctypes): event detection, k-mer ranks,
MoM scalings, the walk decode + QC + postalign, CpG group collection,
eventalign re-alignment and the TSV renderers, in C++ (``src/f5chost.cpp``,
the reference's src/events.c, src/align.c, src/meth.c, src/eventalign.c).

The port's copy of ``f5c_tpu/native``.  The library is compiled with g++
at first use into ``build/f5c_tpu_torch/native/<hash>/`` at the root of
the checkout, keyed by a hash of the source and the flags.  Where it
cannot be built or loaded, ``get_lib`` raises: the port has no slower
host path.  It is loaded as a ``ctypes.CDLL`` of its own (RTLD_LOCAL), so
a process may also hold the JAX package's library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "f5chost.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                           "f5c_tpu_torch", "native")
# -ffp-contract=off: no FMA contraction -- results must be bit-identical
# to the NumPy oracles (strict IEEE f32/f64 op-for-op)
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
          "-ffp-contract=off", "-fno-math-errno")
_PREP_SCRATCH = threading.local()

_lock = threading.Lock()
_lib = None

_i8p = ctypes.POINTER(ctypes.c_char)
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_int = ctypes.c_int
_f32 = ctypes.c_float


@dataclass
class EventTable:
    """Detected events of one read (f5c_tpu/ops/events_ref.py)."""

    start: np.ndarray   # int64 sample index
    length: np.ndarray  # float32 number of samples
    mean: np.ndarray    # float32 pA
    stdv: np.ndarray    # float32 pA


@dataclass
class Scalings:
    """A read's signal scaling (f5c_tpu/ops/abea_ref.py)."""

    shift: float = 0.0
    scale: float = 1.0
    var: float = 1.0


def _build() -> str:
    """Compile the shared library unless this source and these flags
    were built already; returns its path."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(_FLAGS).encode())
    out_dir = os.path.join(_BUILD_ROOT, h.hexdigest()[:16])
    path = os.path.join(out_dir, "libf5chost.so")
    if os.path.isfile(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, path)
    return path


def _declare(lib):
    lib.f5c_detect_events.restype = _i64
    lib.f5c_detect_events.argtypes = [
        _f32p, _i64, _int, _i64p, _f32p, _f32p, _f32p]
    lib.f5c_prep_reads_many.restype = None
    lib.f5c_prep_reads_many.argtypes = [
        _i64, _u64p, _i64p, _f32p, _f32p, _f32p, _int,
        _u64p, _i64p, _int, _f32p, _u64p,
        _u64p, _u64p, _u64p, _u64p, _u64p, _i64p, _i64p, _f32p, _f32p]
    lib.f5c_kmer_ranks.restype = _i64
    lib.f5c_kmer_ranks.argtypes = [_i8p, _i64, _int, _int, _i32p]
    lib.f5c_mom_scalings.restype = None
    lib.f5c_mom_scalings.argtypes = [
        _f32p, _i64, _i32p, _i64, _f32p,
        ctypes.POINTER(_f32), ctypes.POINTER(_f32)]
    lib.f5c_emit_eventalign_tsv.restype = _i64
    lib.f5c_emit_eventalign_tsv.argtypes = [
        _i64p, _i64p, _u8p, _i64, _int,
        _i64p, _f32p, _f32p, _f32p, ctypes.c_void_p,
        _i8p, _i64, _i8p, _i8p,
        _int, _f32p, _f32p, _f32, _f32, _f32, _f32,
        _int, _int, _int, _int,
        _i8p, _i64]
    # all-void-p signature: one marshalling-cheap call per read replaces
    # the adc_to_pa + detect_events + kmer_ranks + mom_scalings sequence
    lib.f5c_prep_read.restype = _i64
    lib.f5c_prep_read.argtypes = [
        ctypes.c_void_p, _i64, _f32, _f32, _f32, _int,
        ctypes.c_void_p, _i64, _int, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(_i64),
        ctypes.POINTER(_f32), ctypes.POINTER(_f32)]
    lib.f5c_format_meth_rows_soa.restype = _i64
    lib.f5c_format_meth_rows_soa.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, _int, _i64,
        _i64p, _i64p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        _i32p,
        ctypes.c_char_p, _i64, _i64p, _i64p,
        ctypes.c_void_p, _i64]
    lib.f5c_svb_zd_decode.restype = _i64
    lib.f5c_svb_zd_decode.argtypes = [_u8p, _i64, _i16p, _i64]
    lib.f5c_svb_zd_encode.restype = _i64
    lib.f5c_svb_zd_encode.argtypes = [_i16p, _i64, _u8p]
    lib.f5c_realign_read.restype = _i64
    lib.f5c_realign_read.argtypes = [
        _i32p, _i32p, _i64, _i64, _int, _i64, _int,
        _f32p, _i64, _i32p, _i64,
        _i64p, _i64p, _i64p, _i64,
        _f32, _f32, _f32, ctypes.c_double,
        _f32p, _f32p, _f32p,
        _i64p, _i64p, _u8p, _i64]
    lib.f5c_decode_qc_postalign.restype = _int
    lib.f5c_decode_qc_postalign.argtypes = [
        _u8p, _i64, _i64, _i32p, _i64, _f32p, _f32p, _f32p, _f32p,
        _f32, _f32, _f32, _i32, _i64,
        _i32p, _i32p, _i32p, _i32p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(_f32), ctypes.POINTER(_f32), ctypes.POINTER(_f32),
        ctypes.POINTER(_f32), ctypes.POINTER(_i32),
        ctypes.POINTER(_i32)]
    lib.f5c_viterbi_chunk.restype = _i64
    lib.f5c_viterbi_chunk.argtypes = [
        _i32p, _i64, _i64, _f32p, _i64, _int, _i64,
        _f32, _f32, _f32, ctypes.c_double,
        _f32p, _f32p, _f32p, _u8p]
    lib.f5c_viterbi_chunk_vp.restype = _i64
    lib.f5c_viterbi_chunk_vp.argtypes = [
        _i32p, _i64, _i64, _f32p, _i64, _int, _i64,
        _f32, _f32, _f32, _f32p,
        _f32p, _f32p, _f32p, _u8p]
    lib.f5c_viterbi_params.restype = None
    lib.f5c_viterbi_params.argtypes = [ctypes.c_double, _f32, _f32p]
    lib.f5c_emit_resquiggle_tsv.restype = _i64
    lib.f5c_emit_resquiggle_tsv.argtypes = [
        ctypes.c_char_p, _i64, _int, _i32p, _i32p, _i64, _i64p, _f32p,
        ctypes.c_void_p, _i64]
    lib.f5c_disambiguate.restype = None
    lib.f5c_disambiguate.argtypes = [_i8p, _i64, _i8p]
    lib.f5c_collect_meth_groups.restype = _i64
    lib.f5c_collect_meth_groups.argtypes = [
        _i8p, _i64, _i64, _i32p, _i32p, _i64, _int, _i64,
        _i32p, _i64, _int,
        _i64p, _i64p, _i32p, _i64p, _i64p, _i64p, _i64p]


def get_lib():
    """The loaded library, built on first call; raises RuntimeError when
    it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(_build())
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", b"") or b""
                raise RuntimeError(
                    "f5c_tpu_torch needs its native host library "
                    f"(f5c_tpu_torch/native/src/f5chost.cpp, g++): {e}\n"
                    + detail.decode(errors="replace")) from e
            _declare(lib)
            _lib = lib
    return _lib


# --- numpy-friendly wrappers ------------------------------------------------

def detect_events(signal_pa: np.ndarray, rna: bool = False):
    """Native event detection (src/events.c)."""
    lib = get_lib()
    sig = np.ascontiguousarray(signal_pa, dtype=np.float32)
    n = sig.shape[0]
    starts = np.empty(n + 1, dtype=np.int64)
    lengths = np.empty(n + 1, dtype=np.float32)
    means = np.empty(n + 1, dtype=np.float32)
    stdvs = np.empty(n + 1, dtype=np.float32)
    ne = lib.f5c_detect_events(sig, n, int(rna), starts, lengths, means,
                               stdvs)
    return EventTable(start=starts[:ne].copy(), length=lengths[:ne].copy(),
                      mean=means[:ne].copy(), stdv=stdvs[:ne].copy())


def prep_reads_many(sigs: list, seqs: list, k: int,
                    level_mean: np.ndarray, rna: bool = False,
                    keep_pa: bool = False):
    """Whole event_single stage for a batch in ONE native call:
    ADC->pA + lane-parallel detect + ranks + MoM (f5c.c:691-745).
    ``sigs`` are Signal records with C-contiguous int16 raw.  Returns a
    list of (EventTable, ranks, Scalings, pa-or-None)."""
    lib = get_lib()
    nb = len(sigs)
    if nb == 0:
        return []
    ns = np.array([s.raw.shape[0] for s in sigs], dtype=np.int64)
    seq_b = [s.encode("ascii") if isinstance(s, str) else s
             for s in seqs]
    seq_lens = np.array([len(s) for s in seq_b], dtype=np.int64)
    starts = [np.empty(n + 1, dtype=np.int64) for n in ns]
    lengths = [np.empty(n + 1, dtype=np.float32) for n in ns]
    means = [np.empty(n + 1, dtype=np.float32) for n in ns]
    stdvs = [np.empty(n + 1, dtype=np.float32) for n in ns]
    rkbufs = [np.empty(max(sl - k + 1, 1), dtype=np.int32)
              for sl in seq_lens]
    pas = ([np.empty(n, dtype=np.float32) for n in ns] if keep_pa
           else None)

    def ptrs(arrs):
        return np.array([a.ctypes.data for a in arrs], dtype=np.uint64)

    def bptrs(bufs):
        return np.array([ctypes.cast(ctypes.c_char_p(b),
                                     ctypes.c_void_p).value or 0
                         for b in bufs], dtype=np.uint64)

    n_events = np.empty(nb, dtype=np.int64)
    n_kmers = np.empty(nb, dtype=np.int64)
    shifts = np.empty(nb, dtype=np.float32)
    scales = np.empty(nb, dtype=np.float32)
    # keep the bytes objects alive across the call
    _keep = seq_b
    lib.f5c_prep_reads_many(
        nb, ptrs([s.raw for s in sigs]), ns,
        np.array([s.digitisation for s in sigs], np.float32),
        np.array([s.offset for s in sigs], np.float32),
        np.array([s.range for s in sigs], np.float32),
        int(rna), bptrs(seq_b), seq_lens, k, level_mean,
        ptrs(pas) if keep_pa else np.zeros(nb, np.uint64),
        ptrs(starts), ptrs(lengths), ptrs(means), ptrs(stdvs),
        ptrs(rkbufs), n_kmers, n_events, shifts, scales)
    out = []
    for r in range(nb):
        ne = n_events[r]
        et = EventTable(start=starts[r][:ne].copy(),
                        length=lengths[r][:ne].copy(),
                        mean=means[r][:ne].copy(),
                        stdv=stdvs[r][:ne].copy())
        sc = Scalings(shift=float(shifts[r]), scale=float(scales[r]))
        out.append((et, rkbufs[r][:n_kmers[r]], sc,
                    pas[r] if keep_pa else None))
    return out


def prep_read(raw: np.ndarray, digitisation: float, offset: float,
              range_: float, seq: str | bytes, k: int,
              level_mean: np.ndarray, rna: bool = False,
              keep_pa: bool = False):
    """Whole event_single stage in one native call (f5c.c:691-745):
    ADC->pA + detect_events + kmer_ranks + MoM.  Returns
    (EventTable, ranks, Scalings, pa-or-None).  raw must be C-contiguous
    int16 (the BLOW5/FAST5 on-disk sample type)."""
    lib = get_lib()
    n = raw.shape[0]
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    ns = len(seq)
    # grow-only per-thread scratch: fresh np.empty of ~1 MB per read is
    # an mmap/munmap + page-fault cycle that costs more than the event
    # detection it feeds (the native side keeps its scratch
    # thread-local for the same reason)
    scr = _PREP_SCRATCH.__dict__
    if scr.get("cap", 0) < n + 1:
        scr["cap"] = cap = max(n + 1, 2 * scr.get("cap", 0))
        scr["starts"] = np.empty(cap, dtype=np.int64)
        scr["lengths"] = np.empty(cap, dtype=np.float32)
        scr["means"] = np.empty(cap, dtype=np.float32)
        scr["stdvs"] = np.empty(cap, dtype=np.float32)
    starts = scr["starts"]
    lengths = scr["lengths"]
    means = scr["means"]
    stdvs = scr["stdvs"]
    ranks = np.empty(max(ns - k + 1, 0), dtype=np.int32)
    pa = np.empty(n, dtype=np.float32) if keep_pa else None
    shift = _f32()
    scale = _f32()
    nk = _i64()
    ne = lib.f5c_prep_read(
        raw.ctypes.data, n, digitisation, offset, range_, int(rna),
        seq, ns, k, level_mean.ctypes.data,
        pa.ctypes.data if pa is not None else None,
        starts.ctypes.data, lengths.ctypes.data, means.ctypes.data,
        stdvs.ctypes.data, ranks.ctypes.data, ctypes.byref(nk),
        ctypes.byref(shift), ctypes.byref(scale))
    # copies: the views would pin the oversized (n+1) scratch buffers
    # for the lifetime of the batch
    et = EventTable(start=starts[:ne].copy(), length=lengths[:ne].copy(),
                    mean=means[:ne].copy(), stdv=stdvs[:ne].copy())
    sc = Scalings(shift=float(shift.value), scale=float(scale.value),
                  var=1.0)
    return et, ranks, sc, pa


def kmer_ranks(seq, k: int, meth: bool = False) -> np.ndarray:
    lib = get_lib()
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    n = len(seq)
    out = np.empty(max(n - k + 1, 0), dtype=np.int32)
    lib.f5c_kmer_ranks(seq, n, k, int(meth), out)
    return out


def mom_scalings(event_means: np.ndarray, ranks: np.ndarray,
                 level_mean: np.ndarray):

    lib = get_lib()
    shift = _f32()
    scale = _f32()
    lib.f5c_mom_scalings(
        np.ascontiguousarray(event_means, dtype=np.float32),
        event_means.shape[0],
        np.ascontiguousarray(ranks, dtype=np.int32), ranks.shape[0],
        level_mean, ctypes.byref(shift), ctypes.byref(scale))
    return Scalings(shift=float(shift.value), scale=float(scale.value),
                    var=1.0)


def emit_eventalign_tsv(ref_position, event_idx, state, rc, ev_starts,
                        ev_lengths, ev_means, ev_stdvs, raw_pa, ref_disamb,
                        ref_offset, contig, name_field, k, level_mean,
                        level_stdv, scale, shift, var, sample_rate,
                        scale_events, write_signal_index, collapse,
                        write_samples, as_bytes: bool = False):
    """Render one read's eventalign TSV rows natively."""
    lib = get_lib()
    n = ref_position.shape[0]
    cap = 256 * max(n, 1)
    if write_samples:
        cap += 16 * int(ev_lengths.sum() + 16 * n)
    raw_ptr = (raw_pa.ctypes.data_as(ctypes.c_void_p)
               if raw_pa is not None else None)
    while True:
        buf = ctypes.create_string_buffer(cap)
        ln = lib.f5c_emit_eventalign_tsv(
            np.ascontiguousarray(ref_position, dtype=np.int64),
            np.ascontiguousarray(event_idx, dtype=np.int64),
            np.ascontiguousarray(state, dtype=np.uint8), n, int(rc),
            np.ascontiguousarray(ev_starts, dtype=np.int64),
            np.ascontiguousarray(ev_lengths, dtype=np.float32),
            np.ascontiguousarray(ev_means, dtype=np.float32),
            np.ascontiguousarray(ev_stdvs, dtype=np.float32),
            raw_ptr, ref_disamb, ref_offset,
            contig.encode(), name_field.encode(), k,
            level_mean, level_stdv, scale, shift, var, sample_rate,
            int(scale_events), int(write_signal_index), int(collapse),
            int(write_samples), buf, cap)
        if ln >= 0:
            raw = buf.raw[:ln]
            return raw if as_bytes else raw.decode("latin1")
        if ln == -2:
            raise ValueError(f"emit_eventalign_tsv: k={k} out of range")
        cap *= 2


def svb_zd_decode(blob: np.ndarray, n_expected: int | None = None
                  ) -> np.ndarray:
    """Decode an svb-zd signal blob to int16 samples."""
    lib = get_lib()
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    cap = n_expected if n_expected is not None else max(
        int.from_bytes(blob[:4].tobytes(), "little"), 1)
    if cap > 4 * max(int(blob.shape[0]), 1):
        # a corrupt count prefix must not drive a giant allocation:
        # every decoded sample needs at least 1 data byte + 1/4 control
        # byte, so count can never exceed 4x the blob size
        raise ValueError("svb-zd: count prefix exceeds what the blob "
                         "could encode (corrupt record)")
    out = np.empty(cap, dtype=np.int16)
    n = lib.f5c_svb_zd_decode(blob, blob.shape[0], out, cap)
    if n < 0:
        raise ValueError("svb-zd: truncated/corrupt blob"
                         if n == -2 else "svb-zd: count exceeds buffer")
    return out[:n]


def svb_zd_encode(samples: np.ndarray) -> np.ndarray:
    """Encode int16 samples as an svb-zd blob."""
    lib = get_lib()
    s = np.ascontiguousarray(samples, dtype=np.int16)
    n = s.shape[0]
    out = np.empty(4 + (n + 3) // 4 + 4 * n, dtype=np.uint8)
    nb = lib.f5c_svb_zd_encode(s, n, out)
    return out[:nb].copy()


def realign_read(fwd_ranks, rc_ranks, ref_len: int, ref_offset: int,
                 k: int, read_len: int, rc: bool, ev_means, b2e_start,
                 segments, scale: float, shift: float, var: float,
                 events_per_base: float, level_mean, level_stdv,
                 level_log_stdv):
    """Whole-read eventalign re-alignment in one native call (the full
    chunk loop of eventalign.c:1267-1531).  ``segments``: list of
    (ref, read) pair arrays [n,2].  -> (ref_position i64, event_idx i64,
    state u8) in forward order."""
    lib = get_lib()
    if not segments:
        z = np.zeros(0, np.int64)
        return z, z.copy(), np.zeros(0, np.uint8)
    seg_ref = np.ascontiguousarray(
        np.concatenate([s[:, 0] for s in segments]), dtype=np.int64)
    seg_read = np.ascontiguousarray(
        np.concatenate([s[:, 1] for s in segments]), dtype=np.int64)
    seg_off = np.zeros(len(segments) + 1, np.int64)
    np.cumsum([s.shape[0] for s in segments], out=seg_off[1:])
    ev = np.ascontiguousarray(ev_means, dtype=np.float32)
    cap = int(ev.shape[0] + seg_ref.shape[0] + 4096)
    while True:
        out_ref = np.empty(cap, np.int64)
        out_ev = np.empty(cap, np.int64)
        out_st = np.empty(cap, np.uint8)
        n = lib.f5c_realign_read(
            np.ascontiguousarray(fwd_ranks, dtype=np.int32),
            np.ascontiguousarray(rc_ranks, dtype=np.int32),
            ref_len, ref_offset, k, read_len, int(rc),
            ev, ev.shape[0],
            np.ascontiguousarray(b2e_start, dtype=np.int32),
            int(np.asarray(b2e_start).shape[0]),
            seg_ref, seg_read, seg_off, len(segments),
            scale, shift, var, events_per_base,
            level_mean, level_stdv, level_log_stdv,
            out_ref, out_ev, out_st, cap)
        if n >= 0:
            return out_ref[:n].copy(), out_ev[:n].copy(), out_st[:n].copy()
        cap *= 2


def viterbi_chunk(ranks: np.ndarray, rank_start: int, rank_stride: int,
                  n_kmers: int, ev_pool: np.ndarray, e_start: int,
                  stride: int, n_events: int, scale: float, shift: float,
                  var: float, events_per_base: float, level_mean,
                  level_stdv, level_log_stdv):
    """One eventalign chunk Viterbi on the host (hmm.c:313-533 with the
    ProfileHMMViterbiOutputR9 policy); returns its movements u8 in walk
    order, n_steps of them (the device kernel's contract, unpacked)."""
    lib = get_lib()
    if n_kmers < 1 or n_events < 1:
        return np.zeros(0, dtype=np.uint8)
    movs = np.empty(n_events + n_kmers + 4, dtype=np.uint8)
    # materialise the (tiny) window contiguously; C walks stride 1
    if rank_stride == 1:
        rview = np.ascontiguousarray(ranks[rank_start:rank_start + n_kmers],
                                     dtype=np.int32)
    else:
        rview = np.ascontiguousarray(
            ranks[max(rank_start - n_kmers + 1, 0):rank_start + 1][::-1],
            dtype=np.int32)
    if rview.shape[0] != n_kmers:
        # a window past the rank array's edge would make C read a
        # shorter buffer than it was promised
        raise ValueError(
            f"viterbi_chunk: rank window [{rank_start} x{rank_stride} "
            f"n={n_kmers}] exceeds rank array ({ranks.shape[0]})")
    n = lib.f5c_viterbi_chunk(
        rview, 1, n_kmers,
        np.ascontiguousarray(ev_pool, dtype=np.float32), e_start, stride,
        n_events, scale, shift, var, events_per_base,
        level_mean, level_stdv, level_log_stdv, movs)
    return movs[:n]


def viterbi_chunk_spec(rank_pool: np.ndarray, spec_i32, spec_f32,
                       consts, ev_pool: np.ndarray, level_mean, level_stdv,
                       level_log_stdv) -> np.ndarray:
    """One chunk of a device round (a row of the specs of
    ops/hmm.py:viterbi_rounds_plain, its 8 constants), replayed by the host
    DP: the movements u8 in walk order."""
    lib = get_lib()
    r0, r_stride, n_kmers, e0, stride, n_events = (int(v) for v in spec_i32)
    if n_kmers < 1 or n_events < 1:
        return np.zeros(0, dtype=np.uint8)
    rview = np.ascontiguousarray(
        rank_pool[r0 + r_stride * np.arange(n_kmers)], dtype=np.int32)
    scale, shift, var, log_var, lp_stay, lp_step = (float(v)
                                                    for v in spec_f32)
    mk, mb, bb, b3, kk, km, pre0 = (float(v) for v in consts[:7])
    vp = np.array([mk, mb, lp_stay, lp_step, bb, b3, kk, km, log_var, pre0],
                  np.float32)
    movs = np.empty(n_events + n_kmers + 4, dtype=np.uint8)
    n = lib.f5c_viterbi_chunk_vp(
        rview, 1, n_kmers, np.ascontiguousarray(ev_pool, dtype=np.float32),
        e0, stride, n_events, scale, shift, var, vp, level_mean, level_stdv,
        level_log_stdv, movs)
    return movs[:n]


def viterbi_params(events_per_base: float, var: float) -> np.ndarray:
    """The f32 transition log probabilities and log(var) of one read's
    chunk Viterbi, exactly as ``viterbi_chunk`` forms them: [lp_mk,
    lp_mb, lp_mm_self, lp_mm_next, lp_bb, lp_b3, lp_kk, lp_km, log_var,
    pre0]."""
    out = np.empty(10, np.float32)
    get_lib().f5c_viterbi_params(events_per_base, var, out)
    return out


def emit_resquiggle_tsv(qname: str, n_kmers: int, rna: bool,
                        b2e_start: np.ndarray, b2e_stop: np.ndarray,
                        ev_start: np.ndarray, ev_len: np.ndarray) -> str:
    """One read's resquiggle TSV rows (resquiggle.c:317-443): per k-mer
    signal start/end, '.' where unaligned, from the (already RNA-flipped)
    base-to-event map."""
    lib = get_lib()
    q = qname.encode()
    cap = int(n_kmers) * (len(q) + 50) + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.f5c_emit_resquiggle_tsv(
        q, int(n_kmers), 1 if rna else 0,
        np.ascontiguousarray(b2e_start, dtype=np.int32),
        np.ascontiguousarray(b2e_stop, dtype=np.int32),
        int(len(ev_start)),
        np.ascontiguousarray(ev_start, dtype=np.int64),
        np.ascontiguousarray(ev_len, dtype=np.float32),
        out, cap)
    if n == -2:
        raise IndexError("resquiggle: event index out of range in the "
                         "base-to-event map")
    if n < 0:
        raise RuntimeError("resquiggle TSV buffer overflow")
    return out.raw[:n].decode("ascii")


def decode_qc_postalign(packed_dirs: np.ndarray, n: int, start_event: int,
                        ranks: np.ndarray, event_means: np.ndarray,
                        level_mean, level_stdv, level_log_stdv,
                        scale: float, shift: float,
                        min_avg_log_emission: float,
                        max_gap_threshold: int,
                        min_num_events_to_rescale: int):
    """Decode walk + alignment QC (avg emission / spanned / max gap,
    src/align.c:526-543) + postalign + recalibrate in one host pass —
    the host half of the event-ring ABEA contract (ops/abea_ring.py).

    -> (failed, calibrated, pairs[n,2], b2e_start, b2e_stop, epb,
        Scalings, sum_em, max_gap)."""
    lib = get_lib()
    n_kmers = ranks.shape[0]
    packed_dirs = np.ascontiguousarray(packed_dirs)
    if n > 0 and ((n + 3) // 4 > packed_dirs.shape[0]
                  or not 0 <= start_event < event_means.shape[0]):
        # inconsistent device walk metadata: report a QC failure
        return (True, False, np.zeros((max(n, 1), 2), np.int32),
                np.full(n_kmers, -1, np.int32),
                np.full(n_kmers, -1, np.int32), 0.0, Scalings(),
                0.0, 0)
    pairs_k = np.empty(max(n, 1), dtype=np.int32)
    pairs_e = np.empty(max(n, 1), dtype=np.int32)
    b2e_start = np.empty(n_kmers, dtype=np.int32)
    b2e_stop = np.empty(n_kmers, dtype=np.int32)
    epb = ctypes.c_double()
    shift_o = _f32()
    scale_o = _f32()
    var_o = _f32()
    sum_em = _f32()
    max_gap = _i32()
    failed = _i32()
    ok = lib.f5c_decode_qc_postalign(
        packed_dirs, n, start_event,
        np.ascontiguousarray(ranks, dtype=np.int32), n_kmers,
        np.ascontiguousarray(event_means, dtype=np.float32),
        level_mean, level_stdv, level_log_stdv,
        scale, shift, min_avg_log_emission, max_gap_threshold,
        min_num_events_to_rescale,
        pairs_k, pairs_e, b2e_start, b2e_stop, ctypes.byref(epb),
        ctypes.byref(shift_o), ctypes.byref(scale_o), ctypes.byref(var_o),
        ctypes.byref(sum_em), ctypes.byref(max_gap), ctypes.byref(failed))
    sc = Scalings(shift=float(shift_o.value), scale=float(scale_o.value),
                  var=float(var_o.value)) if ok else Scalings()
    pairs = np.stack([pairs_k[:n], pairs_e[:n]], axis=1)
    return (bool(failed.value), bool(ok), pairs, b2e_start, b2e_stop,
            float(epb.value), sc, float(sum_em.value), int(max_gap.value))


def disambiguate(seq: bytes) -> bytes:
    lib = get_lib()
    out = ctypes.create_string_buffer(len(seq))
    lib.f5c_disambiguate(seq, len(seq), out)
    return out.raw


def collect_meth_groups(ref_disamb: bytes, ref_start_pos: int,
                        cigar_ops: np.ndarray, cigar_lens: np.ndarray,
                        is_reverse: bool, read_length: int,
                        b2e_start: np.ndarray, k: int):
    """-> dict of group arrays (start_pos, end_pos, n_cpg, sub_start,
    sub_end, e1, e2), each length n_groups."""
    lib = get_lib()
    cap = max(len(ref_disamb), 1)
    g_start = np.empty(cap, dtype=np.int64)
    g_end = np.empty(cap, dtype=np.int64)
    g_ncpg = np.empty(cap, dtype=np.int32)
    g_ss = np.empty(cap, dtype=np.int64)
    g_se = np.empty(cap, dtype=np.int64)
    g_e1 = np.empty(cap, dtype=np.int64)
    g_e2 = np.empty(cap, dtype=np.int64)
    b2e = np.ascontiguousarray(b2e_start, dtype=np.int32)
    n = lib.f5c_collect_meth_groups(
        ref_disamb, len(ref_disamb), ref_start_pos,
        np.ascontiguousarray(cigar_ops, dtype=np.int32),
        np.ascontiguousarray(cigar_lens, dtype=np.int32),
        cigar_ops.shape[0], int(is_reverse), read_length,
        b2e, b2e.shape[0], k,
        g_start, g_end, g_ncpg, g_ss, g_se, g_e1, g_e2)
    return dict(start_pos=g_start[:n].copy(), end_pos=g_end[:n].copy(),
                n_cpg=g_ncpg[:n].copy(), sub_start=g_ss[:n].copy(),
                sub_end=g_se[:n].copy(), e1=g_e1[:n].copy(),
                e2=g_e2[:n].copy())


def format_meth_rows_soa(contig: str, qname: str, strand: int, starts,
                         ends, llm, llu, n_cpg, dis: bytes,
                         seq_start, seq_end) -> bytes:
    """format_meth_rows from struct-of-arrays device outputs: f32
    scores (promoted to double in C exactly like the legacy Python
    float()), sequences as [seq_start, seq_end) byte ranges into the
    read's disambiguated reference segment ``dis``."""
    lib = get_lib()
    n = len(starts)
    seq_start = np.ascontiguousarray(seq_start, np.int64)
    seq_end = np.ascontiguousarray(seq_end, np.int64)
    seq_bytes = int(np.maximum(seq_end - seq_start, 0).sum())
    cap = seq_bytes + n * (len(contig) + len(qname) + 224) + 64
    out = ctypes.create_string_buffer(cap)
    w = lib.f5c_format_meth_rows_soa(
        contig.encode(), qname.encode(), strand, n,
        np.ascontiguousarray(starts, np.int64),
        np.ascontiguousarray(ends, np.int64),
        np.ascontiguousarray(llm, np.float32),
        np.ascontiguousarray(llu, np.float32),
        np.ascontiguousarray(n_cpg, np.int32),
        dis, len(dis), seq_start, seq_end, out, cap)
    if w < 0:
        raise RuntimeError("format_meth_rows_soa overflow")
    return out.raw[:w]

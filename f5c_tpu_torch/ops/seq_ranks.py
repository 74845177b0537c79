"""k-mer ranks from a 2-bit packed sequence (K11).

Counterpart of ``f5c_tpu/ops/seq_ranks.py``.  The host packs each
sequence 4 bases per byte (NumPy, copied below) and uploads the packed
bytes; the ABEA fill kernels rank each k-mer where they stage it
(``csrc/abea_band.cuh`` ``kmer_rank``: K11 fused into K1 and K3).  The
ranks are ``rank[p] = sum_j code[p+j] << 2*(k-1-j)`` (reference rank
function align.c:36-47), bit-identical to ``native.kmer_ranks`` for every
position ``p < n_kmers`` of each read; ``ranks_from_packed`` is their
plain version (the last k-1 positions of a read and the padding hold
garbage that the ABEA fill never reads), ``ranks_at_kmers`` that of the
kernels' rank probe.
"""

from __future__ import annotations

import numpy as np
import torch

# dna_code mapping (f5chost.cpp dna_code): A/other=0 C=1 G=2 T=3
# (copied from f5c_tpu/ops/seq_ranks.py:24-30)
_DNA_LUT = np.zeros(256, np.uint8)
for _ch, _code in (("C", 1), ("G", 2), ("T", 3)):
    _DNA_LUT[ord(_ch)] = _code
    _DNA_LUT[ord(_ch.lower())] = _code


def seq_codes(seq) -> np.ndarray:
    """2-bit codes (u8) for one sequence (str/bytes)
    (f5c_tpu/ops/seq_ranks.py:33)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _DNA_LUT[np.frombuffer(seq, np.uint8)]


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack u8 codes (values 0..3) 4 per byte, first base in the low bits
    (f5c_tpu/ops/seq_ranks.py:40)."""
    n = codes.shape[0]
    buf = np.zeros(4 * max((n + 3) // 4, 1), np.uint8)
    buf[:n] = codes
    q = buf.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
            | (q[:, 3] << 6)).astype(np.uint8)


def pack_seqs(seqs) -> tuple[np.ndarray, np.ndarray]:
    """Pack sequences into one 2-bit buffer (f5c_tpu/ops/seq_ranks.py:54),
    zero-padded to whole 32-bit words (the ABEA fill kernels read it by
    words).

    Returns (packed u8, int64 base offsets): sequence i's base p is code
    ``unpack(packed)[off[i] + p]``.
    """
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    off = np.zeros(len(seqs), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    codes = np.empty(int(lens.sum()), np.uint8)
    for s, o, ln in zip(seqs, off, lens):
        codes[o:o + ln] = seq_codes(s)
    packed = pack_codes(codes)
    return np.concatenate([packed, np.zeros(-packed.shape[0] % 4,
                                            np.uint8)]), off


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """u8 packed bytes -> i32 codes, 4 per byte, low bits first."""
    c = packed.to(torch.int32)
    return torch.stack([c & 3, (c >> 2) & 3, (c >> 4) & 3, (c >> 6) & 3],
                       dim=1).reshape(-1)


def ranks_from_packed(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Rolling 2-bit ranks (i32) of every base position of the packed
    buffer (f5c_tpu/ops/seq_ranks.py:72-88), as integer ops on the
    buffer's device."""
    codes = unpack_codes(packed)
    acc = codes << (2 * (k - 1))
    for j in range(1, k):
        acc = acc + (torch.roll(codes, -j) << (2 * (k - 1 - j)))
    return acc


def kmer_positions(seq_off: torch.Tensor, rk_len: torch.Tensor):
    """The base positions ``seq_off[i] + p`` (p < rk_len[i]) that start a
    k-mer of some read, as an int64 tensor, read after read."""
    n = rk_len.to(torch.int64)
    starts = torch.repeat_interleave(seq_off - (torch.cumsum(n, 0) - n), n)
    return starts + torch.arange(int(n.sum()), device=seq_off.device)


def ranks_at_kmers(seq_packed: torch.Tensor, seq_off: torch.Tensor,
                   rk_len: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version of the rank probe (``abea_cuda.abea_ranks``): i32
    [4 * len(seq_packed)], ``ranks_from_packed``'s rank at every base that
    starts a k-mer of a read, 0 elsewhere."""
    out = torch.zeros(4 * seq_packed.shape[0], dtype=torch.int32,
                      device=seq_packed.device)
    pos = kmer_positions(seq_off, rk_len)
    out[pos] = ranks_from_packed(seq_packed, k)[pos].to(torch.int32)
    return out

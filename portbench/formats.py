"""The benchmark's own writers of the files a lab hands f5c: genome and
reads FASTA, a coordinate-sorted BAM (BGZF) and a BLOW5 file (svb-zd
signals in zlib records, the slow5tools default).

Frozen copies, rewritten to stand alone, of ``f5c_tpu_torch/io/bam.py``
``write_bam``, ``f5c_tpu_torch/io/bgzf.py`` ``BgzfWriter`` and
``f5c_tpu_torch/io/slow5.py`` ``write_blow5`` at commit 5f95a86; the
svb-zd encoder is a NumPy version of ``f5chost.cpp``
``f5c_svb_zd_encode`` (the same bytes).  Imports nothing of the program.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16 = np.full(256, 15, np.uint8)
for _i, _c in enumerate(_SEQ_NT16):
    _NT16[ord(_c)] = _i

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCK = 0xFF00


def write_fasta(path: str, records) -> None:
    """``records``: (name, sequence) pairs, one line a sequence."""
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")


class BgzfWriter:
    def __init__(self, path: str, level: int = 6):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= BLOCK:
            self._flush(bytes(self._buf[:BLOCK]))
            del self._buf[:BLOCK]

    def _flush(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = len(cdata) + 26
        self._f.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                      + struct.pack("<H", 6) + b"BC"
                      + struct.pack("<HH", 2, bsize - 1) + cdata
                      + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                    len(payload)))

    def close(self) -> None:
        if self._buf:
            self._flush(bytes(self._buf))
        self._f.write(BGZF_EOF)
        self._f.close()


def write_bam(path: str, references, records) -> None:
    """``references``: (name, length); ``records``: objects with qname,
    flag, tid, pos, mapq, cigar [(op, len)] and seq, in coordinate
    order.  Base qualities 0xff, no aux tags."""
    w = BgzfWriter(path)
    hdr = "".join(f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in references).encode()
    w.write(b"BAM\x01" + struct.pack("<i", len(hdr)) + hdr
            + struct.pack("<i", len(references)))
    for name, ln in references:
        nb = name.encode() + b"\x00"
        w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
    for r in records:
        qname = r.qname.encode() + b"\x00"
        cig = np.array([(ln << 4) | op for op, ln in r.cigar],
                       np.uint32).tobytes()
        codes = _NT16[np.frombuffer(r.seq.encode(), np.uint8)]
        if codes.shape[0] % 2:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
        body = (struct.pack("<iiBBHHHiiii", r.tid, r.pos, len(qname),
                            r.mapq, 0, len(r.cigar), r.flag, len(r.seq),
                            -1, -1, 0)
                + qname + cig + packed.tobytes() + b"\xff" * len(r.seq))
        w.write(struct.pack("<i", len(body)) + body)
    w.close()


def svb_zd_encode(samples: np.ndarray) -> bytes:
    """svb-zd (slow5lib): u32 count, then StreamVByte keys (2 bits a value,
    4 values a byte) and data (1-4 little-endian bytes a value) of the
    zig-zag deltas."""
    s = np.asarray(samples, np.int16).astype(np.int32)
    n = s.shape[0]
    d = np.diff(s, prepend=np.int32(0))
    zz = ((d << 1) ^ (d >> 31)).astype(np.uint32)
    code = ((zz >= 1 << 8).astype(np.uint8) + (zz >= 1 << 16)
            + (zz >= 1 << 24)).astype(np.uint8)
    keys = np.zeros((n + 3) // 4 * 4, np.uint8)
    keys[:n] = code
    keys = keys.reshape(-1, 4)
    key_bytes = (keys[:, 0] | keys[:, 1] << 2 | keys[:, 2] << 4
                 | keys[:, 3] << 6).astype(np.uint8)
    nbytes = code.astype(np.int64) + 1
    le = zz.astype("<u4").view(np.uint8).reshape(n, 4)
    data = le[np.arange(4)[None, :] < nbytes[:, None]]
    return struct.pack("<I", n) + key_bytes.tobytes() + data.tobytes()


MAGIC, EOF_MARKER, HDR_SIZE_OFFSET = b"BLOW5\x01", b"5WOLB", 64
PRIMARY_TYPES = ["char*", "uint32_t", "double", "double", "double",
                 "double", "uint64_t", "int16_t*"]
PRIMARY_COLS = ["read_id", "read_group", "digitisation", "offset", "range",
                "sampling_rate", "len_raw_signal", "raw_signal"]


def write_blow5(path: str, records, channel, attrs=None) -> None:
    """``records``: (read_id, int16 samples); ``channel``: (digitisation,
    offset, range, sampling rate), the same for every read; ``attrs``:
    header attributes (the chemistry a run's header names)."""
    dig, off, rng, rate = channel
    lines = [f"@{a}\t{v}" for a, v in (attrs or {}).items()]
    lines += ["#" + "\t".join(PRIMARY_TYPES), "#" + "\t".join(PRIMARY_COLS)]
    hdr = ("\n".join(lines) + "\n").encode("latin1")
    chan = struct.pack("<dddd", dig, off, rng, rate)
    with open(path, "wb") as f:
        # version 2.0.0, zlib records, one read group, svb-zd signals
        f.write(MAGIC + bytes([2, 0, 0, 1]) + struct.pack("<I", 1)
                + bytes([1]))
        f.write(b"\x00" * (HDR_SIZE_OFFSET - f.tell()))
        f.write(struct.pack("<I", len(hdr)) + hdr)

        def record(item) -> bytes:
            rid, raw = item
            sig = svb_zd_encode(raw)
            rid = rid.encode("latin1")
            rec = (struct.pack("<H", len(rid)) + rid + struct.pack("<I", 0)
                   + chan + struct.pack("<Q", len(sig)) + sig)
            blob = zlib.compress(rec)
            return struct.pack("<I", len(blob)) + blob

        # records are encoded and compressed on threads (zlib and NumPy
        # release the GIL) and written in order
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            for blob in ex.map(record, records):
                f.write(blob)
        f.write(EOF_MARKER)

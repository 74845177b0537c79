"""BGZF block-compressed format: reader and writer.

BGZF (the container used by BAM, BAI, and bgzipped FASTA) is a sequence of
independently-deflated gzip members of <=64 KiB with the compressed block
size stashed in a gzip extra field (``BC``), enabling random access via
64-bit *virtual offsets* (coffset << 16 | uoffset).

This pure-Python layer is correctness-first; the zlib heavy lifting is C
inside CPython, so decode throughput is adequate for batch loading (a C++
accelerated path can drop in behind the same API).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(18)
    return (
        len(head) >= 18
        and head[:4] == b"\x1f\x8b\x08\x04"
        and head[12:14] == b"BC"
    )


@dataclass
class _Block:
    coffset: int      # compressed (file) offset of the block
    data: bytes       # decompressed payload


class BgzfReader:
    """Random-access BGZF reader with a small block cache."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._cache_off = -1
        self._cache_data = b""
        # current virtual position
        self._block_off = 0
        self._within = 0

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_block_at(self, coffset: int) -> bytes:
        if coffset == self._cache_off:
            return self._cache_data
        self._f.seek(coffset)
        header = self._f.read(18)
        if len(header) < 18:
            return b""
        if header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"{self.path}: not a BGZF block at {coffset}")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = header[12:18] + self._f.read(xlen - 6)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2 : i + 4]
            )[0]
            if si1 == 66 and si2 == 67:  # 'B','C'
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError(f"{self.path}: BGZF block missing BC field")
        # block = 12-byte gzip header + xlen extra + deflate data + 8
        # trailer (crc32 + isize)
        cdata_len = bsize - xlen - 20
        self._f.seek(coffset + 12 + xlen)
        cdata = self._f.read(cdata_len)
        try:
            data = zlib.decompress(cdata, wbits=-15)
        except zlib.error as e:
            # truncated/corrupt block: a catchable reader error, not a
            # raw zlib.error from deep inside an iteration
            raise ValueError(
                f"{self.path}: corrupt/truncated BGZF block at "
                f"{coffset}: {e}") from e
        self._next_off = coffset + bsize
        self._cache_off = coffset
        self._cache_data = data
        return data

    def seek_virtual(self, voffset: int):
        self._block_off = voffset >> 16
        self._within = voffset & 0xFFFF

    def tell_virtual(self) -> int:
        return (self._block_off << 16) | self._within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            data = self._read_block_at(self._block_off)
            if not data:
                if self._within == 0:
                    break
                data = b""
            avail = len(data) - self._within
            if avail <= 0:
                # move to next block
                self._read_block_at(self._block_off)
                self._block_off = self._next_off
                self._within = 0
                # EOF block has zero-length payload; detect real EOF
                probe = self._read_block_at(self._block_off)
                if not probe:
                    break
                continue
            take = min(avail, n)
            out += data[self._within : self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def read_all(self) -> bytes:
        """Decompress the whole file (fast path for full scans)."""
        out = []
        off = 0
        while True:
            data = self._read_block_at(off)
            if data == b"" and self._next_off >= self._file_size():
                break
            out.append(data)
            off = self._next_off
            if off >= self._file_size():
                break
        return b"".join(out)

    def _file_size(self) -> int:
        import os

        return os.fstat(self._f.fileno()).st_size


class BgzfWriter:
    """Streaming BGZF writer (used by the readdb/index builder).
    Records per-block offsets so a ``.gzi`` index can be written for
    random access without full decompression (htslib bgzf_index)."""

    def __init__(self, path: str, level: int = 6):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._blocks: list[tuple[int, int]] = []   # (coffset, uoffset)
        self._uoff = 0

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, payload: bytes):
        self._blocks.append((self._f.tell(), self._uoff))
        self._uoff += len(payload)
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(payload)) + co.flush()
        bsize = len(cdata) + 19 + 6 + 1
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
        )
        trailer = struct.pack(
            "<II", zlib.crc32(bytes(payload)) & 0xFFFFFFFF, len(payload)
        )
        self._f.write(header + cdata + trailer)

    EOF_BLOCK = bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"
    )

    def close(self):
        if self._buf:
            self._flush_block(self._buf)
            self._buf.clear()
        self._f.write(self.EOF_BLOCK)
        self._f.close()

    def write_gzi(self, path: str):
        """Write the htslib .gzi block index: u64 count, then
        (compressed, uncompressed) u64 offset pairs for every block
        after the implicit first (0, 0)."""
        tail = [b for b in self._blocks if b != (0, 0)]
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(tail)))
            for co, uo in tail:
                f.write(struct.pack("<QQ", co, uo))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_gzi(path: str) -> list[tuple[int, int]]:
    """Parse a .gzi block index -> [(coffset, uoffset)] incl. the
    implicit first block at (0, 0), sorted by uoffset."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    out = [(0, 0)]
    for i in range(n):
        co, uo = struct.unpack_from("<QQ", data, 8 + 16 * i)
        out.append((co, uo))
    return out


def decompress_all(path: str) -> bytes:
    """Decompress an entire BGZF (or plain gzip) file into memory."""
    import gzip

    with gzip.open(path, "rb") as f:
        return f.read()

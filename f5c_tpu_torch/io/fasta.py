"""FASTA/FASTQ parsing and faidx-style random access.

Host-side sequence I/O: a streaming FASTA/FASTQ record reader (kseq
equivalent), a ``.fai`` index writer/loader, and random-access subsequence
fetch over plain or BGZF-compressed FASTA (faidx equivalent).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .bgzf import BgzfReader, decompress_all, is_bgzf, read_gzi


def read_fastx(path: str):
    """Yield (name, seq, qual_or_None) from FASTA/FASTQ (plain or gzipped)."""
    import gzip

    opener = gzip.open if path.endswith(".gz") or _is_gzip(path) else open
    with opener(path, "rt") as f:
        name = None
        seq_lines: list[str] = []
        line = f.readline()
        while line:
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(seq_lines), None
                name = line[1:].strip().split()[0]
                seq_lines = []
                line = f.readline()
                while line and not line.startswith((">", "@")):
                    seq_lines.append(line.strip())
                    line = f.readline()
            elif line.startswith("@"):
                name = line[1:].strip().split()[0]
                seq = f.readline().strip()
                f.readline()  # +
                qual = f.readline().strip()
                yield name, seq, qual
                name = None
                line = f.readline()
            else:
                line = f.readline()
        if name is not None:
            yield name, "".join(seq_lines), None


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int       # byte offset of first sequence char
    line_bases: int
    line_bytes: int


def write_fai(fasta_path: str, fai_path: str | None = None) -> dict[str, FaiEntry]:
    """Build a .fai index for a plain (uncompressed) FASTA."""
    fai_path = fai_path or fasta_path + ".fai"
    entries: dict[str, FaiEntry] = {}
    with open(fasta_path, "rb") as f:
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_bytes = 0
        first_line = True
        pos = 0
        for raw in f:
            n = len(raw)
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    entries[name] = FaiEntry(name, length, offset, line_bases,
                                             line_bytes)
                name = line[1:].split()[0].decode()
                length = 0
                offset = pos + n
                first_line = True
            elif name is not None and line:
                if first_line:
                    line_bases = len(line)
                    line_bytes = n
                    first_line = False
                length += len(line)
            pos += n
        if name is not None:
            entries[name] = FaiEntry(name, length, offset, line_bases,
                                     line_bytes)
    with open(fai_path, "w") as f:
        for e in entries.values():
            f.write(f"{e.name}\t{e.length}\t{e.offset}\t{e.line_bases}\t"
                    f"{e.line_bytes}\n")
    return entries


def read_fai(fai_path: str) -> dict[str, FaiEntry]:
    entries: dict[str, FaiEntry] = {}
    with open(fai_path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            entries[cols[0]] = FaiEntry(cols[0], int(cols[1]), int(cols[2]),
                                        int(cols[3]), int(cols[4]))
    return entries


class FastaIndex:
    """faidx-style random access.

    For plain FASTA, fetch seeks using the .fai geometry.  For BGZF
    FASTA (e.g. the readdb ``.index`` file) a ``.gzi`` block index next
    to the file enables streaming seeks at production scale (htslib
    bgzf_useek path); without one the file is decompressed into memory
    (fine for test-sized read sets).
    """

    def __init__(self, fasta_path: str):
        import os as _os

        self.path = fasta_path
        fai = fasta_path + ".fai"
        self._bgzf = is_bgzf(fasta_path)
        self._gzi = None
        self._breader = None
        self._data = None
        if self._bgzf:
            gzi_path = fasta_path + ".gzi"
            if _os.path.exists(gzi_path):
                self._gzi = read_gzi(gzi_path)
                self._breader = BgzfReader(fasta_path)
            else:
                self._data = decompress_all(fasta_path)
        if os.path.exists(fai):
            self.entries = read_fai(fai)
        elif not self._bgzf:
            self.entries = write_fai(fasta_path)
        else:
            # index the decompressed content
            self.entries = self._index_buffer(
                self._data if self._data is not None
                else decompress_all(fasta_path))
        self._fh = None if self._bgzf else open(fasta_path, "rb")

    @staticmethod
    def _index_buffer(data: bytes) -> dict[str, FaiEntry]:
        entries: dict[str, FaiEntry] = {}
        pos = 0
        n = len(data)
        while pos < n:
            eol = data.find(b"\n", pos)
            if eol < 0:
                break
            line = data[pos:eol]
            if line.startswith(b">"):
                name = line[1:].split()[0].decode()
                offset = eol + 1
                # find extent of the sequence
                nxt = data.find(b">", offset)
                seq_block = data[offset : nxt if nxt >= 0 else n]
                first_nl = seq_block.find(b"\n")
                line_bases = first_nl if first_nl >= 0 else len(seq_block)
                length = len(seq_block.replace(b"\n", b"").replace(b"\r", b""))
                entries[name] = FaiEntry(name, length, offset, line_bases,
                                         line_bases + 1)
                pos = nxt if nxt >= 0 else n
            else:
                pos = eol + 1
        return entries

    def names(self) -> list[str]:
        return list(self.entries)

    def fetch(self, name: str, start: int = 0, end: int | None = None) -> str:
        e = self.entries[name]
        if end is None or end > e.length:
            end = e.length
        start = max(0, start)
        if start >= end:
            return ""
        first_line = start // e.line_bases
        last_line = (end - 1) // e.line_bases
        byte_start = e.offset + first_line * e.line_bytes + (
            start - first_line * e.line_bases
        )
        byte_end = e.offset + last_line * e.line_bytes + (
            (end - 1) - last_line * e.line_bases
        ) + 1
        if self._bgzf:
            if self._gzi is not None:
                raw = self._read_bgzf_range(byte_start, byte_end)
            else:
                raw = self._data[byte_start:byte_end]
        else:
            self._fh.seek(byte_start)
            raw = self._fh.read(byte_end - byte_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    def _read_bgzf_range(self, byte_start: int, byte_end: int) -> bytes:
        """Streamed read of an uncompressed range via the .gzi index."""
        import bisect

        uoffs = [u for _, u in self._gzi]
        i = bisect.bisect_right(uoffs, byte_start) - 1
        coff, uoff = self._gzi[i]
        within = byte_start - uoff
        # block payloads are <= 64 KiB, so within fits a virtual offset
        self._breader.seek_virtual((coff << 16) | within)
        return self._breader.read(byte_end - byte_start)

    def close(self):
        if self._fh:
            self._fh.close()

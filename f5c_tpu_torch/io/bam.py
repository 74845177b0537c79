"""BAM reader: header, alignment records, CIGAR, and load filters.

A from-scratch binary BAM parser (the reference links htslib for this;
SAM/BAM is a fixed on-disk spec).  Covers what the pipeline needs:
constant-memory streaming iteration over a coordinate-sorted BAM
(records are parsed from a rolling BGZF-decoded buffer, never the whole
file), qname/flag/tid/pos/mapq/CIGAR/sequence, reverse-strand
detection, reference span, and BAI-backed region queries
(``fetch(tid, beg, end)`` seeking via ``bai.BaiIndex`` — the htslib
``sam_itr_queryi`` path of the reference's src/f5cio.c:476-514).
"""

from __future__ import annotations

import os
import struct

import numpy as np
from dataclasses import dataclass

from .bgzf import BgzfReader

# flag bits (SAM spec)
FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

# CIGAR op codes: MIDNSHP=X
CIGAR_OPS = "MIDNSHP=X"
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = (
    range(9)
)
# ops that consume the reference
_REF_CONSUME = {CMATCH, CDEL, CREF_SKIP, CEQUAL, CDIFF}

_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_DECODE = bytes.maketrans(bytes(range(16)), _SEQ_NT16.encode())


@dataclass
class BamRecord:
    qname: str
    flag: int
    tid: int
    pos: int          # 0-based leftmost ref position
    mapq: int
    cigar: list[tuple[int, int]]   # (op, length)
    l_seq: int
    _seq_packed: bytes
    _aux: bytes = b""
    _qual: bytes = b""
    rnext: int = -1
    pnext: int = -1
    tlen: int = 0

    @property
    def qual(self) -> str:
        """Phred+33 quality string ('*' when absent)."""
        if not self._qual or self._qual[0] == 0xFF:
            return "*"
        return bytes(q + 33 for q in self._qual).decode("latin1")

    def aux_sam_tags(self) -> list[str]:
        """Render the record's aux fields as SAM text tags (the
        reference emits eventalign SAM from the original bam1_t,
        eventalign.c:1891-1994, so original tags must survive)."""
        data = self._aux
        out = []
        i, n = 0, len(data)
        fmts = {ord("c"): ("<b", 1), ord("C"): ("<B", 1),
                ord("s"): ("<h", 2), ord("S"): ("<H", 2),
                ord("i"): ("<i", 4), ord("I"): ("<I", 4)}
        while i + 3 <= n:
            tag = data[i:i + 2].decode("latin1")
            typ = data[i + 2]
            i += 3
            if typ in fmts:
                fmt, sz = fmts[typ]
                v = struct.unpack_from(fmt, data, i)[0]
                i += sz
                out.append(f"{tag}:i:{v}")
            elif typ == ord("A"):
                out.append(f"{tag}:A:{chr(data[i])}")
                i += 1
            elif typ == ord("f"):
                (v,) = struct.unpack_from("<f", data, i)
                i += 4
                out.append(f"{tag}:f:{v:g}")
            elif typ == ord("d"):
                (v,) = struct.unpack_from("<d", data, i)
                i += 8
                out.append(f"{tag}:f:{v:g}")
            elif typ in (ord("Z"), ord("H")):
                j = data.index(b"\x00", i)
                out.append(f"{tag}:{chr(typ)}:"
                           f"{data[i:j].decode('latin1')}")
                i = j + 1
            elif typ == ord("B"):
                sub = data[i]
                (cnt,) = struct.unpack_from("<i", data, i + 1)
                i += 5
                sfmt, ssz = fmts.get(sub, ("<B", 1))
                if sub == ord("f"):
                    sfmt, ssz = "<f", 4
                vals = [struct.unpack_from(sfmt, data, i + k * ssz)[0]
                        for k in range(cnt)]
                i += ssz * cnt
                out.append(f"{tag}:B:{chr(sub)}," +
                           ",".join(f"{v:g}" if sub == ord("f")
                                    else str(v) for v in vals))
            else:
                break
        return out

    def aux_int(self, tag: str, default: int = 0) -> int:
        """Integer aux field (e.g. NM), htslib bam_aux2i semantics."""
        data = self._aux
        t = tag.encode()
        i = 0
        n = len(data)
        sizes = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
                 ord("i"): 4, ord("I"): 4, ord("f"): 4, ord("d"): 8,
                 ord("A"): 1}
        fmts = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h",
                ord("S"): "<H", ord("i"): "<i", ord("I"): "<I"}
        while i + 3 <= n:
            this = data[i:i + 2]
            typ = data[i + 2]
            i += 3
            if typ in sizes:
                if this == t and typ in fmts:
                    return struct.unpack(fmts[typ], data[i:i + sizes[typ]])[0]
                i += sizes[typ]
            elif typ in (ord("Z"), ord("H")):
                j = data.index(b"\x00", i)
                i = j + 1
            elif typ == ord("B"):
                sub = data[i]
                cnt = struct.unpack("<i", data[i + 1:i + 5])[0]
                i += 5 + sizes.get(sub, 1) * cnt
            else:
                break
        return default

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def seq(self) -> str:
        b = np.frombuffer(self._seq_packed, np.uint8)
        codes = np.empty(b.shape[0] * 2, np.uint8)
        codes[0::2] = b >> 4
        codes[1::2] = b & 0xF
        return (codes[:self.l_seq].tobytes()
                .translate(_NT16_DECODE).decode("ascii"))

    def ref_end(self) -> int:
        """One past the last reference base consumed (bam_endpos)."""
        end = self.pos
        for op, ln in self.cigar:
            if op in _REF_CONSUME:
                end += ln
        return end


_CORE = struct.Struct("<iiBBHHHiiii")


def _parse_record(rec: bytes) -> BamRecord:
    (refID, pos, l_rn, mapq, _bin, n_cig, flag, l_seq,
     _nrid, _npos, _tlen) = _CORE.unpack(rec[:32])
    qname = rec[32 : 32 + l_rn - 1].decode("latin1")
    p = 32 + l_rn
    cig_raw = struct.unpack(f"<{n_cig}I", rec[p : p + 4 * n_cig])
    cigar = [(c & 0xF, c >> 4) for c in cig_raw]
    p += 4 * n_cig
    seq_packed = rec[p : p + (l_seq + 1) // 2]
    p += (l_seq + 1) // 2
    qual = rec[p : p + l_seq]
    p += l_seq
    return BamRecord(
        qname=qname, flag=flag, tid=refID, pos=pos, mapq=mapq,
        cigar=cigar, l_seq=l_seq, _seq_packed=seq_packed, _aux=rec[p:],
        _qual=qual, rnext=_nrid, pnext=_npos, tlen=_tlen)


class BamReader:
    """Streams alignment records in file order with constant memory; a
    ``.bai`` next to the file enables seeking region queries."""

    _CHUNK = 1 << 18

    def __init__(self, path: str):
        self.path = path
        r = BgzfReader(path)
        try:
            if r.read(4) != b"BAM\x01":
                raise ValueError(f"{path}: not a BAM file")
            (l_text,) = struct.unpack("<i", r.read(4))
            self.header_text = r.read(l_text).rstrip(b"\x00").decode(
                "latin1")
            (n_ref,) = struct.unpack("<i", r.read(4))
            self.references: list[str] = []
            self.ref_lengths: list[int] = []
            for _ in range(n_ref):
                (l_name,) = struct.unpack("<i", r.read(4))
                self.references.append(
                    r.read(l_name)[:-1].decode("latin1"))
                self.ref_lengths.append(
                    struct.unpack("<i", r.read(4))[0])
            self._body_voff = r.tell_virtual()
        finally:
            r.close()
        self._bai = None

    def __iter__(self):
        """File-order streaming scan (rolling buffer, constant memory)."""
        r = BgzfReader(self.path)
        try:
            r.seek_virtual(self._body_voff)
            buf = b""
            pos = 0
            while True:
                if len(buf) - pos < 4:
                    more = r.read(self._CHUNK)
                    if not more and len(buf) - pos < 4:
                        return
                    buf = buf[pos:] + more
                    pos = 0
                    continue
                (block_size,) = struct.unpack_from("<i", buf, pos)
                if len(buf) - pos - 4 < block_size:
                    more = r.read(max(self._CHUNK, block_size))
                    if not more:
                        return
                    buf = buf[pos:] + more
                    pos = 0
                    continue
                rec = buf[pos + 4 : pos + 4 + block_size]
                pos += 4 + block_size
                yield _parse_record(rec)
        finally:
            r.close()

    def _bai_index(self):
        if self._bai is None:
            bai_path = self.path + ".bai"
            if not os.path.exists(bai_path):
                base, ext = os.path.splitext(self.path)
                alt = base + ".bai"
                bai_path = alt if os.path.exists(alt) else None
            if bai_path is None:
                self._bai = False
            else:
                from .bai import BaiIndex

                self._bai = BaiIndex(bai_path)
        return self._bai or None

    def has_index(self) -> bool:
        return self._bai_index() is not None

    def fetch(self, tid: int, beg: int, end: int):
        """Records overlapping [beg, end) on reference ``tid``, seeking
        through the BAI chunks instead of scanning the file."""
        bai = self._bai_index()
        if bai is None:
            for rec in self:
                if (rec.tid == tid and rec.pos < end
                        and rec.ref_end() > beg):
                    yield rec
            return
        r = BgzfReader(self.path)
        try:
            for vb, ve in bai.chunks(tid, beg, end):
                r.seek_virtual(vb)
                while r.tell_virtual() < ve:
                    head = r.read(4)
                    if len(head) < 4:
                        break
                    (block_size,) = struct.unpack("<i", head)
                    rec = _parse_record(r.read(block_size))
                    if rec.tid != tid or rec.pos >= end:
                        # coordinate-sorted: nothing later in this
                        # chunk can overlap
                        if rec.tid > tid or (rec.tid == tid
                                             and rec.pos >= end):
                            break
                        continue
                    if rec.ref_end() > beg:
                        yield rec
        finally:
            r.close()


def write_bam(path: str, references: list[tuple[str, int]], records,
              header_text: str = ""):
    """Write a minimal BAM (used by tests, --skip-ultra deferral, and the
    synthetic-data generator).  ``records`` yields BamRecord-like objects
    with qname/flag/tid/pos/mapq/cigar/seq fields."""
    from .bgzf import BgzfWriter

    nt16_tab = bytes(
        _SEQ_NT16.index(chr(c)) if chr(c) in _SEQ_NT16 else 15
        for c in range(256))
    with BgzfWriter(path) as w:
        if not header_text:
            header_text = "".join(
                f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in references)
        hdr = header_text.encode()
        w.write(b"BAM\x01" + struct.pack("<i", len(hdr)) + hdr)
        w.write(struct.pack("<i", len(references)))
        for name, ln in references:
            nb = name.encode() + b"\x00"
            w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
        for r in records:
            qname = r.qname.encode() + b"\x00"
            cig = b"".join(struct.pack("<I", (ln << 4) | op)
                           for op, ln in r.cigar)
            seq = r.seq
            codes = np.frombuffer(seq.encode().translate(nt16_tab),
                                  np.uint8)
            if codes.shape[0] % 2:
                codes = np.concatenate([codes, np.zeros(1, np.uint8)])
            packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
            qual = b"\xff" * len(seq)
            body = (struct.pack("<iiBBHHHiiii", r.tid, r.pos, len(qname),
                                r.mapq, 0, len(r.cigar), r.flag, len(seq),
                                -1, -1, 0)
                    + qname + cig + packed.tobytes() + qual)
            w.write(struct.pack("<i", len(body)) + body)


def passes_load_filters(rec: BamRecord, min_mapq: int = 20,
                        keep_secondary: bool = False) -> bool:
    """The batch loader's record filter (reference f5cio.c:550-560):
    mapped, mapq >= min, secondary dropped (supplementary kept)."""
    if rec.is_unmapped or rec.mapq < min_mapq:
        return False
    if rec.is_secondary and not keep_secondary:
        return False
    return True

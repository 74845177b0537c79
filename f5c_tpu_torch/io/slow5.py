"""SLOW5/BLOW5 signal file reader + writer + .idx.

From-scratch implementation of the SLOW5 on-disk formats (spec as
implemented by the reference's vendored slow5lib):

- **BLOW5** (binary): ``BLOW5\\x01`` magic, version, record/signal
  compression method bytes, num_read_groups, header size at offset 64,
  ASCII header block (``@attr`` lines per read group + ``#`` types +
  ``#`` columns), then ``u32 record_size`` + compressed record each, and
  a ``5WOLB`` EOF marker (slow5lib/src/slow5.c:780-905, 3815-4060).
- **SLOW5** (ASCII): the same header as text plus tab-separated records.
- **.idx**: ``SLOW5IDX\\x01`` + version, zero-padded to offset 64, then
  ``u16 id_len + id + u64 offset + u64 size`` per read and an
  ``XDI5WOLS`` EOF marker (slow5lib/src/slow5_idx.c:362-490).

Record compression: none/zlib (zstd gated on the zstandard module);
signal compression: none/svb-zd (StreamVByte zigzag-delta, decoded by
the native library).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from .fast5 import Signal

MAGIC = b"BLOW5\x01"
EOF_MARKER = b"5WOLB"
IDX_MAGIC = b"SLOW5IDX\x01"
IDX_EOF = b"XDI5WOLS"
HDR_SIZE_OFFSET = 64

REC_PRESS = {0: "none", 1: "zlib", 2: "zstd", 250: "svb-zd"}
SIG_PRESS = {0: "none", 1: "svb-zd", 2: "ex-zd", 250: "zlib", 251: "zstd"}
REC_CODE = {v: k for k, v in REC_PRESS.items()}
SIG_CODE = {v: k for k, v in SIG_PRESS.items()}

PRIMARY_TYPES = ["char*", "uint32_t", "double", "double", "double",
                 "double", "uint64_t", "int16_t*"]
PRIMARY_COLS = ["read_id", "read_group", "digitisation", "offset", "range",
                "sampling_rate", "len_raw_signal", "raw_signal"]

# auxiliary type sizes (slow5lib SLOW5_AUX_TYPE_META); arrays are
# length-prefixed with u64
_AUX_SIZES = {
    "int8_t": 1, "uint8_t": 1, "int16_t": 2, "uint16_t": 2,
    "int32_t": 4, "uint32_t": 4, "int64_t": 8, "uint64_t": 8,
    "float": 4, "double": 8, "char": 1, "enum": 1,
}


def _svb_zd_decode(blob: bytes, n_expected=None) -> np.ndarray:
    from .. import native

    return native.svb_zd_decode(np.frombuffer(blob, dtype=np.uint8),
                                n_expected)


def _svb_u32_decode(buf: np.ndarray, count: int):
    """Standard streamvbyte (keys then data, 1-4 LE bytes per value) ->
    (u32 values, bytes consumed).  Vectorised."""
    nk = (count + 3) // 4
    keys = buf[:nk]
    codes = np.empty(count, dtype=np.uint8)
    for j in range(4):
        codes[j::4] = (keys[: (count - j + 3) // 4] >> (2 * j)) & 3
    sizes = codes.astype(np.int64) + 1
    offs = np.concatenate([[0], np.cumsum(sizes[:-1])]) + nk
    vals = np.zeros(count, dtype=np.uint32)
    for nb in (1, 2, 3, 4):
        sel = np.nonzero(sizes == nb)[0]
        for b in range(nb):
            vals[sel] |= buf[offs[sel] + b].astype(np.uint32) << (8 * b)
    return vals, int(nk + sizes.sum())


def _svb_u32_encode(vals: np.ndarray) -> bytes:
    vals = np.asarray(vals, dtype=np.uint32)
    n = vals.shape[0]
    keys = bytearray((n + 3) // 4)
    data = bytearray()
    for i, v in enumerate(vals):
        v = int(v)
        nb = 1 if v < 1 << 8 else 2 if v < 1 << 16 else 3 if v < 1 << 24 \
            else 4
        keys[i // 4] |= (nb - 1) << ((i % 4) * 2)
        data += v.to_bytes(4, "little")[:nb]
    return bytes(keys) + bytes(data)


def _ex_zd_decode(blob: bytes) -> np.ndarray:
    """ex-zd v0 signal codec (slow5lib slow5_press.c:1233-1848):
    [ver u8][nsamples u64][qts u8][first zig-zag delta u16][exception
    block over deltas 1..n-1][non-exception deltas as raw u8], where the
    exception block is [nex u32] + (nex>1: two streamvbyte streams of
    position-deltas-minus-1 and value-256; nex==1: raw u32 pair).
    Deltas un-zigzag + prefix-sum to samples, then << qts."""
    buf = np.frombuffer(blob, dtype=np.uint8)
    ver = blob[0]
    if ver != 0:
        raise RuntimeError(f"unsupported ex-zd version {ver}")
    (nin,) = struct.unpack_from("<Q", blob, 1)
    q = blob[9]
    p = 10
    zd = np.zeros(nin, dtype=np.uint16)
    (zd0,) = struct.unpack_from("<H", blob, p)
    zd[0] = zd0
    p += 2
    (nex,) = struct.unpack_from("<I", blob, p)
    p += 4
    if nex > 1:
        (npp,) = struct.unpack_from("<I", blob, p)
        p += 4
        pos_d, used = _svb_u32_decode(buf[p:p + npp], nex)
        p += npp
        (nvp,) = struct.unpack_from("<I", blob, p)
        p += 4
        ex, used = _svb_u32_decode(buf[p:p + nvp], nex)
        p += nvp
        ex_pos = np.cumsum(pos_d.astype(np.int64) + 1) - 1
    elif nex == 1:
        (pos0,) = struct.unpack_from("<I", blob, p)
        p += 4
        (v0,) = struct.unpack_from("<I", blob, p)
        p += 4
        ex_pos = np.array([pos0], dtype=np.int64)
        ex = np.array([v0], dtype=np.uint32)
    else:
        ex_pos = np.zeros(0, dtype=np.int64)
        ex = np.zeros(0, dtype=np.uint32)
    rest = np.ones(nin - 1, dtype=bool)
    rest[ex_pos] = False
    tail = zd[1:]
    tail[ex_pos] = (ex + 256).astype(np.uint16)
    n_small = int(rest.sum())
    tail[rest] = buf[p:p + n_small].astype(np.uint16)
    d = ((zd >> 1).astype(np.int32)) ^ -(zd & 1).astype(np.int32)
    out = np.cumsum(d).astype(np.int16)
    if q:
        out = (out << q).astype(np.int16)
    return out


def _ex_zd_encode(samples: np.ndarray) -> bytes:
    s = np.asarray(samples, dtype=np.int16)
    nin = s.shape[0]
    # quantisation: largest q <= 5 with all low bits zero
    q = 5
    while q and np.any(s & ((1 << q) - 1)):
        q -= 1
    sq = (s >> q).astype(np.int16)
    d = np.diff(np.concatenate([[np.int16(0)], sq])).astype(np.int16)
    zd = (((d.astype(np.int32) * 2) ^ (d.astype(np.int32) >> 15))
          .astype(np.uint16))
    out = bytearray()
    out += bytes([0])
    out += struct.pack("<Q", nin)
    out += bytes([q])
    out += struct.pack("<H", int(zd[0]))
    tail = zd[1:]
    ex_pos = np.nonzero(tail > 255)[0]
    nex = ex_pos.shape[0]
    out += struct.pack("<I", nex)
    if nex > 1:
        pos_d = np.diff(np.concatenate([[-1], ex_pos])) - 1
        pb = _svb_u32_encode(pos_d.astype(np.uint32))
        out += struct.pack("<I", len(pb)) + pb
        vb = _svb_u32_encode((tail[ex_pos].astype(np.uint32)) - 256)
        out += struct.pack("<I", len(vb)) + vb
    elif nex == 1:
        out += struct.pack("<I", int(ex_pos[0]))
        out += struct.pack("<I", int(tail[ex_pos[0]]) - 256)
    small = tail[tail <= 255].astype(np.uint8)
    out += small.tobytes()
    return bytes(out)


def _svb_zd_encode(samples: np.ndarray) -> bytes:
    from .. import native

    return native.svb_zd_encode(samples).tobytes()


@dataclass
class Slow5Header:
    version: tuple
    num_read_groups: int
    rec_press: str
    sig_press: str
    attrs: dict               # attr -> [value per read group]
    aux_types: list           # type strings beyond the 8 primary columns
    aux_names: list


def _parse_ascii_header(text: str, num_read_groups: int) -> tuple:
    attrs = {}
    aux_types: list[str] = []
    aux_names: list[str] = []
    for line in text.split("\n"):
        if not line:
            continue
        cols = line.split("\t")
        if line.startswith("@"):
            attrs[cols[0][1:]] = cols[1:]
        elif line.startswith("#"):
            first = cols[0][1:]
            if first in ("char*", "uint32_t"):      # types line
                aux_types = cols[8:]
            elif first == "read_id":                 # columns line
                aux_names = cols[8:]
    return attrs, aux_types, aux_names


class Slow5File:
    """Random-access SLOW5/BLOW5 reader (read_id -> Signal)."""

    def __init__(self, path: str, create_index_if_missing: bool = True):
        self.path = path
        self._fh = open(path, "rb")
        magic = self._fh.read(6)
        self._fh.seek(0)
        try:
            if magic == MAGIC:
                self._binary = True
                self._parse_binary_header()
            else:
                self._binary = False
                self._parse_ascii_file_header()
        except (RuntimeError, OSError):
            raise
        except Exception as e:
            raise RuntimeError(
                f"corrupt/truncated slow5 header in {path}: {e}") from e
        self._index: dict[str, tuple[int, int]] | None = None
        self._idx_path = path + ".idx"
        if os.path.exists(self._idx_path):
            try:
                self._load_index()
            except Exception:
                # corrupt/stale .idx: rebuild from the data file
                # rather than failing the run (slow5_idx_load re-creates
                # on version mismatch too)
                if create_index_if_missing:
                    self.create_index()
                else:
                    raise
        elif create_index_if_missing:
            self.create_index()

    # -- headers -----------------------------------------------------------
    def _parse_binary_header(self):
        f = self._fh
        assert f.read(6) == MAGIC
        major, minor, patch, rec_m = struct.unpack("<BBBB", f.read(4))
        (n_groups,) = struct.unpack("<I", f.read(4))
        sig_m = struct.unpack("<B", f.read(1))[0] if (major, minor) >= (0, 2) \
            else 0
        f.seek(HDR_SIZE_OFFSET)
        (hdr_size,) = struct.unpack("<I", f.read(4))
        text = f.read(hdr_size).decode("latin1")
        attrs, aux_types, aux_names = _parse_ascii_header(text, n_groups)
        self.header = Slow5Header(
            version=(major, minor, patch), num_read_groups=n_groups,
            rec_press=REC_PRESS.get(rec_m, "?"),
            sig_press=SIG_PRESS.get(sig_m, "?"),
            attrs=attrs, aux_types=aux_types, aux_names=aux_names)
        self._records_off = HDR_SIZE_OFFSET + 4 + hdr_size

    def _parse_ascii_file_header(self):
        f = self._fh
        n_groups = 1
        version = (1, 0, 0)
        lines = []
        pos = f.tell()
        while True:
            line = f.readline().decode("latin1")
            if not line:
                break
            if line.startswith("#slow5_version") or line.startswith(
                    "#num_read_groups"):
                parts = line.rstrip("\n").split("\t")
                if parts[0] == "#slow5_version":
                    version = tuple(int(x) for x in parts[1].split("."))
                else:
                    n_groups = int(parts[1])
                lines.append(line)
            elif line.startswith("@") or line.startswith("#"):
                lines.append(line)
                if line.startswith("#read_id"):
                    break
            else:
                f.seek(pos)
                break
            pos = f.tell()
        attrs, aux_types, aux_names = _parse_ascii_header(
            "".join(lines), n_groups)
        self.header = Slow5Header(
            version=version, num_read_groups=n_groups, rec_press="none",
            sig_press="none", attrs=attrs, aux_types=aux_types,
            aux_names=aux_names)
        self._records_off = f.tell()

    # -- index -------------------------------------------------------------
    def _load_index(self):
        idx = {}
        with open(self._idx_path, "rb") as f:
            assert f.read(9) == IDX_MAGIC, "bad slow5 idx magic"
            f.seek(HDR_SIZE_OFFSET)
            data = f.read()
        off = 0
        n = len(data)
        while off < n:
            if data[off : off + 8] == IDX_EOF:
                break
            (idl,) = struct.unpack_from("<H", data, off)
            off += 2
            rid = data[off : off + idl].decode("latin1")
            off += idl
            o, s = struct.unpack_from("<QQ", data, off)
            off += 16
            idx[rid] = (o, s)
        self._index = idx

    def create_index(self):
        """Scan records, build the in-memory index and write ``.idx``
        (slow5_idx_create)."""
        idx = {}
        try:
            for rid, off, size in self._scan_records():
                idx[rid] = (off, size)
        except (RuntimeError, OSError):
            raise
        except Exception as e:
            raise RuntimeError(
                f"corrupt/truncated slow5 file {self.path}: {e}") from e
        self._index = idx
        tmp = self._idx_path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(IDX_MAGIC)
            f.write(bytes(self.header.version[:3]))
            f.write(b"\x00" * (HDR_SIZE_OFFSET - 9 - 3))
            for rid, (o, s) in idx.items():
                f.write(struct.pack("<H", len(rid)))
                f.write(rid.encode("latin1"))
                f.write(struct.pack("<QQ", o, s))
            f.write(IDX_EOF)
        os.replace(tmp, self._idx_path)

    def _scan_records(self):
        """Yield (read_id, file_offset, size) for every record."""
        f = self._fh
        f.seek(self._records_off)
        if self._binary:
            while True:
                off = f.tell()
                hdr = f.read(4)
                if len(hdr) < 4:
                    break
                if hdr[:4] == EOF_MARKER[:4]:
                    nxt = f.read(1)
                    if hdr + nxt == EOF_MARKER:
                        break
                    f.seek(off + 4)
                (size,) = struct.unpack("<I", hdr)
                blob = f.read(size)
                rec = self._depress_record(blob)
                (idl,) = struct.unpack_from("<H", rec, 0)
                rid = rec[2 : 2 + idl].decode("latin1")
                yield rid, off, size + 4
        else:
            while True:
                off = f.tell()
                line = f.readline()
                if not line or line.startswith(b"#") or line.startswith(b"@"):
                    if not line:
                        break
                    continue
                rid = line.split(b"\t", 1)[0].decode("latin1")
                yield rid, off, len(line)

    # -- record fetch --------------------------------------------------------
    def _depress_record(self, blob: bytes) -> bytes:
        m = self.header.rec_press
        if m == "none":
            return blob
        if m == "zlib":
            return zlib.decompress(blob)
        if m == "zstd":
            try:
                import zstandard
            except ImportError as e:
                raise RuntimeError(
                    "zstd-compressed BLOW5 needs the zstandard module"
                ) from e
            return zstandard.ZstdDecompressor().decompress(blob)
        raise RuntimeError(f"unsupported record compression {m}")

    def read_ids(self):
        return list(self._index.keys()) if self._index else []

    def get(self, read_id: str) -> Signal:
        return self.decode_record(self.read_record_bytes(read_id),
                                  read_id)

    def read_record_bytes(self, read_id: str) -> bytes:
        """The file-I/O half of get(): index lookup + raw record read.
        Callers that share one reader across threads need only lock
        THIS call — decode_record is lock-free, so record
        decompression parallelises over host cores (the role of
        slow5lib's slow5_mt multi-thread fetch, slow5_mt.c)."""
        if self._index is None:
            self.create_index()
        if read_id not in self._index:
            raise KeyError(read_id)
        off, size = self._index[read_id]
        self._fh.seek(off)
        return self._fh.read(size)

    def decode_record(self, data: bytes, read_id: str = "") -> Signal:
        # normalise decode failures (truncated file, corrupt blob,
        # codec errors from zlib/zstd/svb) to RuntimeError so callers
        # can skip-and-count unreadable records (f5cio.c:435-447)
        # without knowing every backend's exception type
        try:
            if self._binary:
                rec = self._depress_record(data[4:])
                return self._parse_binary_record(rec)
            return self._parse_ascii_record(data.decode("latin1"))
        except (KeyError, RuntimeError, OSError):
            raise
        except Exception as e:
            raise RuntimeError(
                f"corrupt/unreadable slow5 record [{read_id}] in "
                f"{self.path}: {e}") from e

    def _parse_binary_record(self, rec: bytes) -> Signal:
        (idl,) = struct.unpack_from("<H", rec, 0)
        p = 2 + idl
        rid = rec[2:p].decode("latin1")
        (_rg,) = struct.unpack_from("<I", rec, p)
        p += 4
        digitisation, offset, range_, sampling_rate = struct.unpack_from(
            "<dddd", rec, p)
        p += 32
        (len_raw,) = struct.unpack_from("<Q", rec, p)
        p += 8
        if self.header.sig_press == "svb-zd":
            raw = _svb_zd_decode(rec[p : p + len_raw])
        elif self.header.sig_press == "ex-zd":
            raw = _ex_zd_decode(rec[p : p + len_raw])
        elif self.header.sig_press == "none":
            raw = np.frombuffer(rec, dtype="<i2", count=len_raw, offset=p)
        else:
            raise RuntimeError(
                f"unsupported signal compression {self.header.sig_press}")
        return Signal(read_id=rid, raw=np.asarray(raw, dtype=np.int16),
                      digitisation=digitisation, offset=offset,
                      range=range_, sample_rate=sampling_rate)

    def _parse_ascii_record(self, line: str) -> Signal:
        cols = line.rstrip("\n").split("\t")
        raw = np.array([int(x) for x in cols[7].split(",")], dtype=np.int16)
        return Signal(read_id=cols[0], raw=raw,
                      digitisation=float(cols[2]), offset=float(cols[3]),
                      range=float(cols[4]), sample_rate=float(cols[5]))

    def __iter__(self):
        """Yield Signal for every record in file order."""
        for rid, off, size in self._scan_records():
            yield self.get(rid)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# Writer (round-trip testing + FAST5 -> BLOW5 conversion utility)
# --------------------------------------------------------------------------

def write_blow5(path: str, signals, rec_press: str = "zlib",
                sig_press: str = "svb-zd",
                attrs: dict | None = None):
    """Write Signal records to a BLOW5 file (+ no aux columns)."""
    attrs = attrs or {}
    hdr_lines = []
    for a, v in attrs.items():
        hdr_lines.append(f"@{a}\t{v}")
    hdr_lines.append("#" + "\t".join(PRIMARY_TYPES))
    hdr_lines.append("#" + "\t".join(PRIMARY_COLS))
    hdr_text = ("\n".join(hdr_lines) + "\n").encode("latin1")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(bytes([2, 0, 0]))                  # version 2.0.0
        f.write(bytes([REC_CODE[rec_press]]))
        f.write(struct.pack("<I", 1))              # num_read_groups
        f.write(bytes([SIG_CODE[sig_press]]))
        f.write(b"\x00" * (HDR_SIZE_OFFSET - f.tell()))
        f.write(struct.pack("<I", len(hdr_text)))
        f.write(hdr_text)
        for sig in signals:
            rid = sig.read_id.encode("latin1")
            raw = np.ascontiguousarray(sig.raw, dtype=np.int16)
            if sig_press == "svb-zd":
                sig_bytes = _svb_zd_encode(raw)
                len_raw = len(sig_bytes)
            elif sig_press == "ex-zd":
                sig_bytes = _ex_zd_encode(raw)
                len_raw = len(sig_bytes)
            else:
                sig_bytes = raw.tobytes()
                len_raw = raw.shape[0]
            rec = (struct.pack("<H", len(rid)) + rid
                   + struct.pack("<I", 0)
                   + struct.pack("<dddd", sig.digitisation, sig.offset,
                                 sig.range, sig.sample_rate)
                   + struct.pack("<Q", len_raw)
                   + (sig_bytes if isinstance(sig_bytes, bytes)
                      else bytes(sig_bytes)))
            if rec_press == "zlib":
                blob = zlib.compress(rec)
            elif rec_press == "zstd":
                import zstandard

                blob = zstandard.ZstdCompressor().compress(rec)
            elif rec_press == "none":
                blob = rec
            else:
                raise ValueError(f"unsupported writer compression "
                                 f"{rec_press}")
            f.write(struct.pack("<I", len(blob)))
            f.write(blob)
        f.write(EOF_MARKER)


def write_slow5(path: str, signals, attrs: dict | None = None):
    """Write Signal records as ASCII SLOW5."""
    attrs = attrs or {}
    with open(path, "w") as f:
        f.write("#slow5_version\t2.0.0\n#num_read_groups\t1\n")
        for a, v in attrs.items():
            f.write(f"@{a}\t{v}\n")
        f.write("#" + "\t".join(PRIMARY_TYPES) + "\n")
        f.write("#" + "\t".join(PRIMARY_COLS) + "\n")
        for sig in signals:
            raw = ",".join(str(int(x)) for x in sig.raw)
            f.write(f"{sig.read_id}\t0\t{sig.digitisation:g}\t"
                    f"{sig.offset:g}\t{sig.range:g}\t{sig.sample_rate:g}\t"
                    f"{sig.raw.shape[0]}\t{raw}\n")

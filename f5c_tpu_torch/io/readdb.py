"""Read database: maps read_id -> (sequence, signal path).

Equivalent of the reference's ReadDB (src/nanopolish_read_db.{h,c}) +
``f5c index`` (src/index.c): a BGZF-compressed FASTA copy of the reads
(``<reads>.index``) with a .fai, plus a plaintext two-column
``<reads>.index.readdb`` mapping read_id -> FAST5 path.  For SLOW5/BLOW5
inputs only the FASTA copy is needed (signals are fetched by read_id from
the .blow5 index).
"""

from __future__ import annotations

import os

from .bgzf import BgzfWriter
from .fasta import FastaIndex, read_fastx


class ReadDB:
    def __init__(self, reads_path: str):
        self.reads_path = reads_path
        self.index_path = reads_path + ".index"
        self.readdb_path = self.index_path + ".readdb"
        self._fa: FastaIndex | None = None
        self._paths: dict[str, str] | None = None

    # -- build (the `index` subcommand) -------------------------------
    def build(self, fast5_dirs: list[str] | None = None,
              slow5_path: str | None = None,
              sequencing_summary: list[str] | None = None,
              iop: int = 1):
        """Create .index (bgzf fasta), .fai, and .readdb."""
        with BgzfWriter(self.index_path) as w:
            for name, seq, _ in read_fastx(self.reads_path):
                w.write(f">{name}\n{seq}\n".encode())
        # .gzi block index: random access into the bgzf copy without
        # whole-file decompression (htslib bgzf_index_dump)
        w.write_gzi(self.index_path + ".gzi")
        # fai over the *decompressed* content: FastaIndex handles bgzf
        fa = FastaIndex(self.index_path)
        with open(self.index_path + ".fai", "w") as f:
            for e in fa.entries.values():
                f.write(f"{e.name}\t{e.length}\t{e.offset}\t{e.line_bases}\t"
                        f"{e.line_bytes}\n")
        paths: dict[str, str] = {}
        if fast5_dirs:
            mapping = {}
            if sequencing_summary:
                for ss in sequencing_summary:
                    mapping.update(parse_sequencing_summary(ss, fast5_dirs))
                # reads not covered by the summaries fall back to the scan
                missing = [rid for rid in fa.entries if rid not in mapping]
            else:
                missing = list(fa.entries)
            if missing:
                mapping.update(scan_fast5_dirs(fast5_dirs, iop=iop))
            for rid in fa.entries:
                if rid in mapping:
                    paths[rid] = mapping[rid]
        with open(self.readdb_path, "w") as f:
            for rid, p in paths.items():
                f.write(f"{rid}\t{p}\n")
        self._fa = fa
        self._paths = paths

    # -- load ----------------------------------------------------------
    def load(self):
        self._fa = FastaIndex(self.index_path)
        self._paths = {}
        if os.path.exists(self.readdb_path):
            with open(self.readdb_path) as f:
                for line in f:
                    cols = line.rstrip("\n").split("\t")
                    if len(cols) == 2:
                        self._paths[cols[0]] = cols[1]
        return self

    def get_read_sequence(self, read_id: str) -> str:
        if self._fa is None:
            self.load()
        if read_id not in self._fa.entries:
            return ""
        return self._fa.fetch(read_id)

    def get_signal_path(self, read_id: str) -> str:
        if self._paths is None:
            self.load()
        return self._paths.get(read_id, "")

    def has_read(self, read_id: str) -> bool:
        if self._fa is None:
            self.load()
        return read_id in self._fa.entries


def parse_sequencing_summary(path: str, fast5_dirs: list[str]
                             ) -> dict[str, str]:
    """read_id -> FAST5 path from a basecaller sequencing summary
    (index.c:209-254: needs a 'read_id' column and a 'filename' or
    'filename_fast5' column; filenames resolve against the FAST5 dirs)."""
    import gzip

    op = gzip.open if path.endswith(".gz") else open
    # filename -> full path lookup over the provided directories
    by_name: dict[str, str] = {}
    for d in fast5_dirs:
        for root, _dirs, files in os.walk(d):
            for fn in files:
                if fn.endswith(".fast5"):
                    by_name[fn] = os.path.join(root, fn)
    mapping: dict[str, str] = {}
    with op(path, "rt") as f:
        header = f.readline().rstrip("\n").split("\t")
        try:
            rid_idx = header.index("read_id")
        except ValueError:
            raise ValueError(f"{path}: no read_id column") from None
        fn_idx = None
        for cand in ("filename", "filename_fast5"):
            if cand in header:
                fn_idx = header.index(cand)
        if fn_idx is None:
            raise ValueError(f"{path}: no filename column")
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= max(rid_idx, fn_idx):
                continue
            full = by_name.get(os.path.basename(cols[fn_idx]))
            if full:
                mapping[cols[rid_idx]] = full
    return mapping


def _scan_one_fast5(path: str) -> list[tuple[str, str]]:
    from .fast5 import Fast5File

    try:
        with Fast5File(path) as f5:
            return [(rid, path) for rid in f5.read_ids()]
    except OSError:
        return []


def scan_fast5_dirs(dirs: list[str], iop: int = 1) -> dict[str, str]:
    """Recursively scan directories for FAST5 files, mapping read_id->path.

    ``iop`` > 1 fans the per-file HDF5 opens out over worker processes
    (the reference forks scanner processes the same way, index.c:509-602;
    HDF5 is not usable from threads).
    """
    paths = []
    for d in dirs:
        for root, _dirs, files in os.walk(d):
            for fn in sorted(files):
                if fn.endswith(".fast5"):
                    paths.append(os.path.join(root, fn))
    mapping: dict[str, str] = {}
    if iop > 1 and len(paths) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
                max_workers=iop,
                mp_context=mp.get_context("spawn")) as pool:
            for pairs in pool.map(_scan_one_fast5, paths, chunksize=16):
                mapping.update(pairs)
    else:
        for path in paths:
            mapping.update(_scan_one_fast5(path))
    return mapping

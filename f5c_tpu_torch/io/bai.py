"""BAI (BAM binning index) reader — region queries without scanning.

From-scratch parser of the `.bai` format (SAM spec §5.2; the reference
reaches it through htslib's ``sam_itr_queryi``,
src/f5cio.c:476-514 and src/f5c.c:300-340).  The index
is the standard UCSC 5-level binning scheme (bins of 512 Mb .. 16 kb)
plus a 16 kb linear index of smallest virtual offsets; a region query
collects the chunk lists of every bin overlapping the region, drops
chunks that end before the linear index's lower bound, and merges the
rest into a minimal list of (virtual-offset) intervals to stream.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


def reg2bins(beg: int, end: int) -> list[int]:
    """All bin numbers overlapping [beg, end) (SAM spec §5.3)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


@dataclass
class _RefIndex:
    bins: dict[int, list[tuple[int, int]]]   # bin -> [(voff_beg, voff_end)]
    intervals: list[int]                     # 16 kb linear index (voffsets)


class BaiIndex:
    """Parsed .bai file; ``chunks(tid, beg, end)`` yields merged virtual
    offset ranges that cover every record overlapping the region."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.refs: list[_RefIndex] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                ch = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    ch.append((beg, end))
                bins[bin_id] = ch
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            intervals = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            self.refs.append(_RefIndex(bins=bins, intervals=intervals))

    def chunks(self, tid: int, beg: int, end: int
               ) -> list[tuple[int, int]]:
        """Merged (voffset_beg, voffset_end) ranges for the region."""
        if tid < 0 or tid >= len(self.refs) or end <= beg:
            return []
        ref = self.refs[tid]
        # linear index lower bound: records before this voffset cannot
        # overlap the region
        iv = beg >> 14
        min_off = 0
        if ref.intervals:
            iv = min(iv, len(ref.intervals) - 1)
            min_off = ref.intervals[iv]
        raw = []
        for b in reg2bins(beg, end):
            for cb, ce in ref.bins.get(b, ()):
                if ce > min_off:
                    raw.append((max(cb, min_off), ce))
        raw.sort()
        merged: list[tuple[int, int]] = []
        for cb, ce in raw:
            if merged and cb <= merged[-1][1]:
                if ce > merged[-1][1]:
                    merged[-1] = (merged[-1][0], ce)
            else:
                merged.append((cb, ce))
        return merged

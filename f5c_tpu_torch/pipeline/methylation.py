"""One read's methylation calls, as the port's runner hands them to the
TSV renderer.  The part of ``f5c_tpu/pipeline/methylation.py`` that the
port reaches: the group collection itself is native
(``native.collect_meth_groups``) and the scores come from the HMM
forward kernel."""

from __future__ import annotations


class MethCalls:
    """One read's methylation calls as struct-of-arrays: ascending-unique
    start positions (native collect_meth_groups scans CpGs left to right)
    with parallel end/n_cpg/score arrays and the read's disambiguated
    reference segment for sequence rendering."""

    __slots__ = ("starts", "ends", "n_cpg", "llu", "llm", "dis",
                 "r_pos", "k")

    def __init__(self, starts, ends, n_cpg, llu, llm, dis: bytes,
                 r_pos: int, k: int):
        self.starts = starts
        self.ends = ends
        self.n_cpg = n_cpg
        self.llu = llu
        self.llm = llm
        self.dis = dis
        self.r_pos = r_pos
        self.k = k

    def __len__(self):
        return len(self.starts)

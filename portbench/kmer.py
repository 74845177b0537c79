"""Pore-model tables (k-mer -> current level) as the benchmark reads them.

``tables/*.npz`` are frozen copies of the port's built-in tables
(``f5c_tpu_torch/models/data/`` at commit 5f95a86: ONT's published R9.4.1
450 bps 6-mer nucleotide and CpG tables and the RNA004 5-mer table); the
ranks follow ``f5c_tpu_torch/models/pore_model.py`` (f5c align.c:36-47,
hmm.c:30-61).  The generators simulate signal from them and the
reference scores against them; neither takes the program's copies.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

TABLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tables")
_DNA = np.zeros(256, np.int64)
for _i, _b in enumerate("ACGT"):
    _DNA[ord(_b)] = _i
_METH = np.zeros(256, np.int64)
for _i, _b in enumerate("ACGMT"):
    _METH[ord(_b)] = _i


@dataclass
class Model:
    k: int
    alphabet: str            # "nucleotide" (ACGT) or "meth" (ACGMT)
    level_mean: np.ndarray   # f32, by k-mer rank
    level_stdv: np.ndarray
    level_log_stdv: np.ndarray = field(init=False)

    def __post_init__(self):
        self.level_mean = np.asarray(self.level_mean, np.float32)
        self.level_stdv = np.asarray(self.level_stdv, np.float32)
        self.level_log_stdv = np.log(self.level_stdv).astype(np.float32)

    def kmer_ranks(self, seq) -> np.ndarray:
        """The rank of every k-mer of ``seq`` (first base most
        significant; other letters rank as A)."""
        if isinstance(seq, str):
            seq = seq.encode("ascii")
        codes = (_METH if self.alphabet == "meth" else _DNA)[
            np.frombuffer(bytes(seq), np.uint8)]
        n = codes.shape[0] - self.k + 1
        if n <= 0:
            return np.zeros(0, np.int64)
        base = 5 if self.alphabet == "meth" else 4
        ranks = np.zeros(n, np.int64)
        for i in range(self.k):
            ranks = ranks * base + codes[i:i + n]
        return ranks


def load(name: str) -> Model:
    """The table ``tables/<name>.npz``."""
    z = np.load(os.path.join(TABLE_DIR, name + ".npz"), allow_pickle=False)
    return Model(int(z["k"]), str(z["alphabet"]), z["level_mean"],
                 z["level_stdv"])

"""Pore models: k-mer -> Gaussian(level_mean, level_stdv) lookup tables.

A pore model maps every k-mer of an alphabet (nucleotide ACGT or
cytosine-methylation-aware ACGMT) to the expected pico-ampere current level
and its standard deviation.  On the device the whole table lives
as two float32 vectors indexed by k-mer rank; emission probabilities are a
gather + fused elementwise Gaussian log-pdf.

File format parity: f5c/nanopolish text models (reference: src/model.c
read_model; header lines ``#k <int>`` etc., rows ``KMER\tmean\tstdv...``).

Built-in models are stored as ``.npz`` files under ``f5c_tpu_torch/models/data/``,
generated from the ONT-published model tables vendored by the reference
(test/r9-models, test/rna004-models) by ``scripts/convert_models.py``.
These are measured instrument calibration DATA (Oxford Nanopore pore
characterisations), not code.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

# Alphabet ranks. DNA: A=0 C=1 G=2 T=3 (2-bit, align.c:19-47).
# Methylation alphabet: A=0 C=1 G=2 M=3 T=4 (base-5, hmm.c:30-61).
_DNA_RANK = np.full(256, 0, dtype=np.int64)
for i, b in enumerate("ACGT"):
    _DNA_RANK[ord(b)] = i
_METH_RANK = np.full(256, 0, dtype=np.int64)
for i, b in enumerate("ACGMT"):
    _METH_RANK[ord(b)] = i


def _seq_to_codes(seq: str | bytes | np.ndarray, table: np.ndarray) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), dtype=np.uint8)
    return table[seq]


def kmer_ranks_dna(seq: str | bytes | np.ndarray, k: int) -> np.ndarray:
    """Rank of every k-mer of ``seq`` in the ACGT alphabet (vectorised).

    rank(kmer) = sum_i rank(base_i) * 4^(k-1-i)  — i.e. the first base is
    the most significant digit, matching get_kmer_rank (align.c:36-47).
    Non-ACGT characters rank as A (align.c:28-31 warns and returns 0).
    """
    codes = _seq_to_codes(seq, _DNA_RANK)
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    ranks = np.zeros(n, dtype=np.int64)
    for i in range(k):
        ranks = (ranks << 2) + codes[i : i + n]
    return ranks


def kmer_ranks_meth(seq: str | bytes | np.ndarray, k: int) -> np.ndarray:
    """Rank of every k-mer of ``seq`` in the ACGMT (base-5) alphabet."""
    codes = _seq_to_codes(seq, _METH_RANK)
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    ranks = np.zeros(n, dtype=np.int64)
    for i in range(k):
        ranks = ranks * 5 + codes[i : i + n]
    return ranks


@dataclass
class PoreModel:
    """A loaded pore model table.

    ``level_mean``/``level_stdv``/``level_log_stdv`` are float32 vectors of
    length ``alphabet_size ** k`` indexed by k-mer rank.  ``level_log_stdv``
    is precomputed (CACHED_LOG, f5c.h:86).
    """

    k: int
    alphabet: str                    # "nucleotide" (ACGT) or "meth" (ACGMT)
    level_mean: np.ndarray
    level_stdv: np.ndarray
    name: str = ""
    meta: dict = field(default_factory=dict)
    level_log_stdv: np.ndarray = field(init=False)

    def __post_init__(self):
        self.level_mean = np.asarray(self.level_mean, dtype=np.float32)
        self.level_stdv = np.asarray(self.level_stdv, dtype=np.float32)
        expected = (5 if self.alphabet == "meth" else 4) ** self.k
        if self.level_mean.shape[0] != expected:
            raise ValueError(
                f"model has {self.level_mean.shape[0]} kmers, expected "
                f"{expected} for k={self.k} alphabet={self.alphabet}"
            )
        self.level_log_stdv = np.log(self.level_stdv).astype(np.float32)

    @property
    def num_kmers(self) -> int:
        return self.level_mean.shape[0]

    def kmer_ranks(self, seq, *_, **__) -> np.ndarray:
        if self.alphabet == "meth":
            return kmer_ranks_meth(seq, self.k)
        return kmer_ranks_dna(seq, self.k)

    def save_npz(self, path: str):
        np.savez_compressed(
            path,
            k=self.k,
            alphabet=self.alphabet,
            name=self.name,
            level_mean=self.level_mean,
            level_stdv=self.level_stdv,
        )

    @staticmethod
    def load_npz(path: str) -> "PoreModel":
        z = np.load(path, allow_pickle=False)
        k = int(z["k"])
        if not 1 <= k <= 9:     # MAX_KMER_SIZE (f5c.h:30); the native
            # emitters use 16-byte kmer buffers sized for this bound
            raise ValueError(f"{path}: k-mer size {k} out of range (1..9)")
        return PoreModel(
            k=k,
            alphabet=str(z["alphabet"]),
            name=str(z["name"]),
            level_mean=z["level_mean"],
            level_stdv=z["level_stdv"],
        )


def load_model_file(path: str, alphabet: str | None = None) -> PoreModel:
    """Parse an f5c/nanopolish text model file, with an ``.npz`` cache.

    Header lines start with ``#`` (``#k <int>`` gives the k-mer size,
    ``#alphabet <name>`` the alphabet); an optional column-header row starts
    with ``kmer``; data rows are ``KMER\\tlevel_mean\\tlevel_stdv[...]``.
    The alphabet is inferred from the row count when not given
    (4^k rows -> nucleotide, 5^k rows -> meth).

    Parsed tables are cached as ``<path>.npz`` (mtime-checked; disable
    with ``F5C_TPU_MODEL_CACHE=0``): a 9-mer CpG table is 1.95M rows,
    and the text parse costs seconds where the npz loads in
    milliseconds (the reference bakes its big tables into the binary —
    src/model.h / methmodel.c — so it never pays a parse).
    """
    use_cache = os.environ.get("F5C_TPU_MODEL_CACHE", "1") != "0"
    cache = path + ".npz"
    if use_cache:
        try:
            if (os.path.isfile(cache)
                    and os.path.getmtime(cache) >= os.path.getmtime(path)):
                m = PoreModel.load_npz(cache)
                if alphabet is None or m.alphabet == alphabet:
                    return m
        except (OSError, ValueError, KeyError):
            pass             # stale/corrupt cache: re-parse below
    m = _parse_model_file(path, alphabet)
    if use_cache:
        try:
            m.save_npz(cache)
        except OSError:
            pass             # read-only model dir: cache is best-effort
    return m


def _parse_model_file(path: str, alphabet: str | None = None) -> PoreModel:
    k = None
    meta: dict = {}
    kmers: list[str] = []
    means: list[float] = []
    stdvs: list[float] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("#"):
                # the reference parses headers with sscanf("%s\t%d")
                # (model.c:69), which accepts any whitespace — split
                # likewise so "#k 6" and "#k\t6" both work
                parts = line[1:].split(None, 1)
                if len(parts) >= 2:
                    meta[parts[0]] = parts[1].strip()
                    if parts[0] == "k":
                        try:
                            # only the first token: "#k\t6\t<extra>"
                            # is legal (the reference's sscanf stops at
                            # the integer)
                            k = int(parts[1].split()[0])
                        except (ValueError, IndexError) as e:
                            raise ValueError(
                                f"{path}:{lineno}: invalid #k header "
                                f"{line!r}") from e
                        if k <= 0 or k > 9:      # MAX_KMER_SIZE, f5c.h:30
                            raise ValueError(
                                f"{path}: k-mer size {k} out of range "
                                f"(1..9)")
                continue
            if line.startswith("kmer\t") or line.startswith("kmer "):
                continue
            cols = line.split("\t")
            try:
                kmers.append(cols[0])
                means.append(float(cols[1]))
                stdvs.append(float(cols[2]))
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"{path}:{lineno}: malformed model row "
                    f"{line[:60]!r} (need KMER\\tmean\\tstdv)") from e
    if not kmers:
        raise ValueError(f"{path}: no k-mer rows found")
    if k is None:
        k = len(kmers[0])
    n = len(kmers)
    if alphabet is None:
        if n == 4**k:
            alphabet = "nucleotide"
        elif n == 5**k:
            alphabet = "meth"
        else:
            raise ValueError(f"{path}: {n} rows is neither 4^{k} nor 5^{k}")
    base = 5 if alphabet == "meth" else 4
    size = base ** k
    # vectorised rank computation over the concatenated k-mer column
    # (a per-row rank call costs ~18us x 1.95M rows on a 9-mer CpG table)
    joined = "".join(kmers)
    if len(joined) != n * k:
        bad = next(km for km in kmers if len(km) != k)
        raise ValueError(f"{path}: k-mer {bad!r} is not length {k}")
    # direct-RNA tables are published over ACGU; the pipeline works in
    # U->T space (reads are U->T converted at load, f5cio.c)
    codes = (_METH_RANK if alphabet == "meth" else _DNA_RANK)[
        np.frombuffer(joined.replace("U", "T").encode("latin1"),
                      dtype=np.uint8)].reshape(n, k)
    ranks = np.zeros(n, dtype=np.int64)
    for i in range(k):
        ranks = ranks * base + codes[:, i]
    counts = np.bincount(ranks, minlength=size)
    if (counts > 1).any():
        r = int(np.nonzero(counts > 1)[0][0])
        dup = kmers[int(np.nonzero(ranks == r)[0][1])]
        raise ValueError(f"{path}: duplicate k-mer {dup!r}")
    if (counts == 0).any():
        raise ValueError(
            f"{path}: {int((counts == 0).sum())} of {size} k-mers missing "
            f"from the table")
    level_mean = np.zeros(size, dtype=np.float32)
    level_stdv = np.ones(size, dtype=np.float32)
    level_mean[ranks] = np.asarray(means, dtype=np.float32)
    level_stdv[ranks] = np.asarray(stdvs, dtype=np.float32)
    return PoreModel(
        k=k,
        alphabet=alphabet,
        level_mean=level_mean,
        level_stdv=level_stdv,
        name=meta.get("ont_model_name", os.path.basename(path)),
        meta=meta,
    )


# Built-in registry: model-id -> npz filename.  Mirrors f5cmisc.h:24-30
# (MODEL_ID_DNA_NUCLEOTIDE / DNA_CPG / RNA_NUCLEOTIDE / RNA004_NUCLEOTIDE).
# R10.4.1 9-mer tables are not redistributable from the stripped reference;
# use --kmer-model/--meth-model with a custom file for R10.
BUILTIN_MODELS = {
    "dna_r9_nucleotide": "r9.4_450bps.nucleotide.6mer.npz",
    "dna_r9_cpg": "r9.4_450bps.cpg.6mer.npz",
    "rna_r9_nucleotide": "r9.4_70bps.u_to_t_rna.5mer.npz",
    "rna004_nucleotide": "rna004.nucleotide.5mer.npz",
}

_cache: dict[str, PoreModel] = {}


def builtin_model(model_id: str) -> PoreModel:
    if model_id not in BUILTIN_MODELS:
        raise KeyError(
            f"unknown builtin model {model_id!r}; have {sorted(BUILTIN_MODELS)}"
        )
    if model_id not in _cache:
        path = os.path.join(_DATA_DIR, BUILTIN_MODELS[model_id])
        _cache[model_id] = PoreModel.load_npz(path)
    return _cache[model_id]

"""The port's windowed ABEA for ultra-long reads (f5c_tpu_torch/ops/
abea_ultra.py), bit for bit, and its routing in the port's Pipeline.

- the plain windowed path against the JAX package's align_ultra_read in
  interpret mode, one read of 300 k-mers in windows of 256 bands;
- against the port's plain unchunked abea_align and the NumPy oracle
  abea_ref.align on mixed reads (around 128 k-mers, bands that straddle
  the trim column, a read with no events whose start_e is -1, a read
  that fails QC), in windows of 97, 256 and 1,000 bands;
- the routing rule, on the routing function alone;
- the golden reads forced through the windowed path in the Pipeline on
  the CPU: the same pairs and scalings as the normal path, and 0 deviant
  rows against meth.exp from the CLI;
- --skip-ultra / --ultra-thresh through the port's CLI;
- the tiled window walk's plain version (walk_window_tiled_plain) window
  by window against walk_window_plain inside the windowed path (windows
  of 97 and 256 bands, tiles of 4, 16 and 128; walks that carry n % 4 !=
  0) and on random windows (synthetic.window_walk_cases: a walk carried
  in above the last row, the clamp; no walk; mid-byte).
"""

import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_golden_e2e import GOLDEN, _tolerant_compare

from f5c_tpu.models import builtin_model
from f5c_tpu.ops.abea_ref import Scalings
from f5c_tpu_torch import datasets, synthetic
from f5c_tpu_torch.ops import abea_cuda, abea_ultra, abea_ultra_cuda
from f5c_tpu_torch.ops.abea import read_params
from f5c_tpu_torch.ops.seq_ranks import ranks_from_packed
from f5c_tpu_torch.pipeline.runner import Options, Pipeline

N_KMERS = [20, 45, 100, 127, 128, 129, 250, 400, 90]
UNRELATED = 6         # events that do not follow the sequence: fails QC
NO_EVENTS = 8         # no events at all: start_e == -1
FORCE_BUDGET = 1_000_000   # every golden read over its share of a wave
FORCE_WIN = 300
FLOAT_COLS = {4, 5, 6}     # meth-out-version 1: llr, ll_meth, ll_unmeth

# the wrappers' arguments: the reads' sequences 2-bit packed
FIELDS = ("ev_pool", "ev_off", "ev_len", "seq_packed", "seq_off", "rk_len",
          "k", "level_mean", "level_stdv", "level_log_stdv", "params",
          "band_off", "byte_off")


def _dirs(flat, off, n):
    """First n 2-bit walk directions of one read."""
    b = np.asarray(flat[off:off + (n + 3) // 4], np.uint8)
    d = np.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], 1)
    return d.reshape(-1)[:n]


@pytest.fixture(scope="module")
def model():
    return builtin_model("dna_r9_nucleotide")


@pytest.fixture(scope="module")
def mixed(model):
    rng = np.random.default_rng(21)
    seqs, events = synthetic.abea_reads(rng, N_KMERS, model,
                                        unrelated=(UNRELATED,))
    events[NO_EVENTS] = events[NO_EVENTS][:0]
    B = len(seqs)
    scale = rng.uniform(0.97, 1.03, B).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    with np.errstate(divide="ignore"):      # log(p_stay) of 0 events
        x = synthetic.abea_inputs(seqs, events, model, scale, shift)
    t = {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
             else v) for k, v in x.items()}
    unchunked = abea_cuda.abea_align(*(t[k] for k in FIELDS), x["n_bands"],
                                     x["n_bytes"])
    return seqs, events, scale, shift, x, t, unchunked


def test_plain_matches_jax_align_ultra_read(model, monkeypatch):
    from f5c_tpu.ops.abea_ultra import align_ultra_read

    rng = np.random.default_rng(7)
    seqs, events = synthetic.abea_reads(rng, [300], model)
    ranks = model.kmer_ranks(seqs[0]).astype(np.int32)
    params = read_params(np.array([events[0].shape[0]], np.int32),
                         np.array([ranks.shape[0]], np.int32),
                         np.float32([1.02]), np.float32([0.3]))[0]
    [(packed, n, start_e)] = abea_ultra.align_ultra_plain(
        [(events[0], ranks, params)], model.level_mean, model.level_stdv,
        model.level_log_stdv, win=256)
    with monkeypatch.context() as m:
        m.setenv("F5C_TPU_INTERPRET", "1")
        packed_j, n_j, start_j = align_ultra_read(
            events[0], ranks, model.level_mean, model.level_stdv,
            model.level_log_stdv, *(float(v) for v in params),
            win_bands=256, interpret=True)
    assert (n, start_e) == (n_j, start_j)
    assert n > 0 and ranks.shape[0] + events[0].shape[0] + 2 > 3 * 256
    np.testing.assert_array_equal(packed, packed_j)


@pytest.mark.parametrize("win", [97, 256, 1000])
def test_plain_windowed_matches_unchunked(mixed, win):
    _seqs, _events, _scale, _shift, x, t, unchunked = mixed
    got = abea_ultra_cuda.abea_align_windowed(
        *(t[k] for k in FIELDS), x["n_bytes"],
        int(np.diff(x["band_off"]).max()), win)
    for g, w in zip(got, unchunked):
        assert torch.equal(g, w)
    start_e, n = unchunked[1].numpy(), unchunked[2].numpy()
    assert start_e[NO_EVENTS] == -1 and n[NO_EVENTS] == 0
    assert (np.delete(n, NO_EVENTS) > 0).all()


def test_plain_windowed_matches_numpy_oracle(model, mixed):
    from f5c_tpu.ops.abea import decode_packed_dirs
    from f5c_tpu.ops.abea_ref import align

    seqs, events, scale, shift, x, t, _ = mixed
    flat, start_e, n = (a.numpy() for a in abea_ultra_cuda.abea_align_windowed(
        *(t[k] for k in FIELDS), x["n_bytes"],
        int(np.diff(x["band_off"]).max()), 256))
    n_failed = 0
    for i, (seq, ev) in enumerate(zip(seqs, events)):
        if i == NO_EVENTS:
            continue
        ref = align(seq, ev, model, Scalings(shift=float(shift[i]),
                                             scale=float(scale[i])))
        assert n[i] == ref.n_aligned, i
        n_failed += ref.failed
        if ref.failed:
            continue
        pairs = decode_packed_dirs(flat[x["byte_off"][i]:], int(n[i]),
                                   int(start_e[i]), int(x["rk_len"][i]))
        np.testing.assert_array_equal(pairs, ref.pairs, err_msg=str(i))
    assert n_failed == 1


def test_window_state_and_trace_layout(mixed):
    """A window's trace and llk are the unchunked trace's rows of its
    bands, and the checkpoint after n windows resumes to the same state
    as running them in one call."""
    _seqs, _events, _scale, _shift, x, t, _ = mixed
    args = [t[k] for k in FIELDS[:12]]
    trace, llk, _ = abea_cuda.abea_fill(*args, x["n_bands"])
    s0 = abea_ultra.initial_state(t["params"])
    whole, tr, lk = abea_ultra_cuda.abea_fill_window(*args, s0, 2, 97, 3,
                                                     True)
    part, _, _ = abea_ultra_cuda.abea_fill_window(*args, s0, 2, 97, 2, False)
    rest, tr2, lk2 = abea_ultra_cuda.abea_fill_window(
        *args, part[:, 1].contiguous(), 2 + 2 * 97, 97, 1, True)
    # packed rows: TRACE_ROW_BYTES a band, in the unchunked fill and in
    # the windows
    band_off = x["band_off"]
    B = len(band_off) - 1
    assert trace.shape == (x["n_bands"], 32)
    assert tr.shape == (B, 3 * 97, 32) and tr2.shape == (B, 97, 32)
    # state records hold ints as f32 bits: compare bits
    assert torch.equal(whole[:, 2].view(torch.int32),
                       rest[:, 0].view(torch.int32))
    assert torch.equal(tr[:, 2 * 97:], tr2) and torch.equal(lk[:, 194:], lk2)
    for i in range(len(band_off) - 1):
        nb = int(band_off[i + 1] - band_off[i])
        m = min(nb - 2, 3 * 97)
        rows = slice(int(band_off[i]) + 2, int(band_off[i]) + 2 + m)
        assert torch.equal(tr[i, :m], trace[rows])
        assert torch.equal(lk[i, :m], llk[rows])
        assert not tr[i, m:].any() and not lk[i, m:].any()


def _read(n_bases: int, n_events: int):
    return SimpleNamespace(qname="r", seq="A" * n_bases, n_events=n_events)


def test_routing_rule(model):
    """A read takes the windowed path when n_bands x (32 + 4) bytes (2
    bits a band cell and the band's lower-left k-mer) exceeds
    TRACE_BYTES_BUDGET / WAVE (31.25 MB, 868,055 bands at the defaults);
    a read past the JAX runner's TPU limits no longer raises."""
    pipe = Pipeline.bare(Options(), model)
    assert (pipe.TRACE_BYTES_BUDGET, pipe.WAVE) == (4_000_000_000, 128)
    assert pipe.WIN_BANDS == 1 << 16
    k = model.k
    assert not pipe._takes_window_path(_read(70_000 + k - 1, 1000))
    cap = pipe.TRACE_BYTES_BUDGET // (pipe.WAVE * 36)
    assert cap == 868_055
    L = 300_000
    under = _read(L, cap - (L - k + 1) - 2)
    over = _read(L, cap + 1 - (L - k + 1) - 2)
    assert not pipe._takes_window_path(under)
    assert pipe._takes_window_path(over)


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("golden_ultra"))
    datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB), tmp)
    return tmp


def _truth():
    with open(os.path.join(GOLDEN, "meth.exp")) as f:
        return f.read()


def _pipeline(golden_dir, **kw):
    class Recording(Pipeline):
        """Keeps every read's ABEA result and the windowed batches."""

        def _finish_abea(self, todo, ranks, launch):
            super()._finish_abea(todo, ranks, launch)
            for r in todo:
                sc = r.scaling
                self.seen[r.qname] = (r.status, r.pairs, sc.shift, sc.scale,
                                      sc.var)

        def _align_ultra_batch(self, todo, ranks):
            self.ultra_batches.append(len(todo))
            super()._align_ultra_batch(todo, ranks)

    opt = Options(min_mapq=0, meth_out_version=1,
                  slow5_path=os.path.join(golden_dir, "signals.blow5"), **kw)
    pipe = Recording(os.path.join(golden_dir, "reads.bam"),
                     os.path.join(golden_dir, "genome.fa"),
                     os.path.join(golden_dir, "reads.fasta"), opt,
                     device=torch.device("cpu"))
    pipe.seen, pipe.ultra_batches = {}, []
    return pipe


@pytest.mark.parametrize("print_raw", [False, True])
def test_pipeline_window_path_matches_normal(golden_dir, print_raw, capsys):
    """print_raw=False takes the waves, True align_batch (BAM order)."""
    normal = _pipeline(golden_dir, print_raw=print_raw)
    normal.call_methylation(out=io.StringIO())
    forced = _pipeline(golden_dir, print_raw=print_raw)
    forced.TRACE_BYTES_BUDGET = FORCE_BUDGET
    forced.WIN_BANDS = FORCE_WIN
    out = io.StringIO()
    forced.call_methylation(out=out)
    capsys.readouterr()
    assert normal.ultra_batches == [] and forced.ultra_batches == [6]
    assert forced.counters["processed"] == 6
    assert set(normal.seen) == set(forced.seen) and len(normal.seen) == 6
    for q, a in normal.seen.items():
        b = forced.seen[q]
        assert a[0] == b[0] == 0, q
        np.testing.assert_array_equal(a[1], b[1], err_msg=q)
        assert a[2:] == b[2:], q
    _tolerant_compare(out.getvalue(), _truth(), FLOAT_COLS)


def _cli(golden_dir, out_path, *extra):
    from f5c_tpu_torch.cli import main

    return main(["call-methylation", "--device", "cpu", "--min-mapq", "0",
                 "--meth-out-version", "1",
                 "-b", os.path.join(golden_dir, "reads.bam"),
                 "-g", os.path.join(golden_dir, "genome.fa"),
                 "-r", os.path.join(golden_dir, "reads.fasta"),
                 "--slow5", os.path.join(golden_dir, "signals.blow5"),
                 "-o", out_path, *extra])


def test_cli_window_path_golden(golden_dir, monkeypatch):
    routed = []
    align_ultra_batch = Pipeline._align_ultra_batch

    def spy(self, todo, ranks):
        routed.extend(r.qname for r in todo)
        align_ultra_batch(self, todo, ranks)

    monkeypatch.setattr(Pipeline, "TRACE_BYTES_BUDGET", FORCE_BUDGET)
    monkeypatch.setattr(Pipeline, "WIN_BANDS", FORCE_WIN)
    monkeypatch.setattr(Pipeline, "_align_ultra_batch", spy)
    out_path = os.path.join(golden_dir, "meth_windowed.tsv")
    assert _cli(golden_dir, out_path) == 0
    assert len(routed) == 6
    with open(out_path) as f:
        _tolerant_compare(f.read(), _truth(), FLOAT_COLS)


def test_cli_skip_ultra(golden_dir):
    from f5c_tpu.io.bam import BamReader

    bam_out = os.path.join(golden_dir, "ultra.bam")
    out_path = os.path.join(golden_dir, "meth_short.tsv")
    assert _cli(golden_dir, out_path, "--skip-ultra", bam_out,
                "--ultra-thresh", "1100") == 0
    deferred = sorted(r.qname for r in BamReader(bam_out))
    assert deferred == ["gr0", "gr1", "gr3", "gr4"]
    keep = {"gr2", "gr5"}
    truth = _truth().rstrip("\n").split("\n")
    want = [truth[0]] + [ln for ln in truth[1:]
                         if ln.split("\t")[3] in keep]
    with open(out_path) as f:
        _tolerant_compare(f.read(), "\n".join(want) + "\n", FLOAT_COLS)


def test_ultra_dataset_reads_take_window_path(tmp_path, model):
    """At the default budget every read of the 100-300 kb synthetic set
    stays on the unchunked path (the longest has 811,435 bands, under the
    share of 868,055), and under chip_smoke.py's forced budget (a share of
    datasets.ULTRA_WINDOWED_SHARE bands) every read is routed to the
    windowed path (events detected as the pipeline does; nothing
    aligned)."""
    from f5c_tpu import native
    from f5c_tpu.io.fasta import read_fastx
    from f5c_tpu.io.slow5 import Slow5File

    d = datasets.ultra_dataset(str(tmp_path / "ultra"))
    seqs = {q: s for q, s, _ in read_fastx(d["reads"])}
    assert sorted(len(s) // 1000 for s in seqs.values()) == [100, 150, 200,
                                                            300]
    pipe = Pipeline.bare(Options(), model)
    forced = Pipeline.bare(Options(), model)
    forced.TRACE_BYTES_BUDGET = (forced.WAVE * 36
                                 * datasets.ULTRA_WINDOWED_SHARE)
    f = Slow5File(d["slow5"])
    bands = []
    try:
        for q in f.read_ids():
            n_events = native.detect_events(f.get(q).to_pa()).mean.shape[0]
            r = SimpleNamespace(qname=q, seq=seqs[q], n_events=n_events)
            bands.append(n_events + len(seqs[q]) - model.k + 3)
            assert not pipe._takes_window_path(r), q
            assert forced._takes_window_path(r), q
    finally:
        f.close()
    assert sorted(bands) == [270_240, 406_214, 541_387, 811_435]


def test_ultra_dataset_windowed_matches_unchunked(tmp_path):
    """A small copy of the ultra set through call-methylation on the CPU,
    every read windowed, then none: byte-identical output."""
    d = datasets.ultra_dataset(str(tmp_path / "ultra"), scale=0.01)
    out = {}
    for budget in (1_000_000, 4_000_000_000):
        pipe = Pipeline(d["bam"], d["genome"], d["reads"],
                        Options(min_mapq=0, slow5_path=d["slow5"]),
                        device=torch.device("cpu"))
        pipe.TRACE_BYTES_BUDGET = budget
        pipe.WIN_BANDS = 1000
        buf = io.StringIO()
        pipe.call_methylation(out=buf)
        assert pipe.counters["processed"] == 4
        assert pipe.stage_detail["align.ultra_reads"] == (
            4 if budget == 1_000_000 else 0)
        out[budget] = buf.getvalue()
    assert out[1_000_000] == out[4_000_000_000]
    assert len({ln.split("\t")[4] for ln in out[1_000_000].split("\n")[1:]
                if ln}) == 4


@pytest.mark.parametrize("tile", [4, 16, 128])
@pytest.mark.parametrize("win", [97, 256])
def test_tiled_window_walk_matches_plain(mixed, win, tile):
    """The windowed path with every window walked by the plain tiled walk
    (abea_ultra.walk_window_tiled_plain) equals the unchunked ABEA bit for
    bit, and each window's (k, e, n) and bytes equal walk_window_plain's;
    windows whose walk starts mid-byte (the carried n % 4 != 0) among
    them."""
    _seqs, _events, _scale, _shift, x, t, unchunked = mixed
    mid = []

    def walk(trace, llk, base, kst, flat, byte_off):
        want = abea_ultra.walk_window_plain(trace, llk, base, kst, flat,
                                            byte_off)
        got = abea_ultra.walk_window_tiled_plain(trace, llk, base, kst,
                                                 flat, byte_off, tile)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), base
        mid.append(int(((kst[:, 2] % 4 != 0) & (kst[:, 0] >= 0)).sum()))
        return got

    got = abea_ultra.align_windowed(
        t["ev_pool"], t["ev_off"], t["ev_len"],
        ranks_from_packed(t["seq_packed"], x["k"]), t["seq_off"],
        *(t[k] for k in ("rk_len", "level_mean", "level_stdv",
                         "level_log_stdv", "params", "band_off",
                         "byte_off")), x["n_bytes"],
        int(np.diff(x["band_off"]).max()), win, walk=walk)
    for g, w in zip(got, unchunked):
        assert torch.equal(g, w)
    assert sum(mid) > 0


@pytest.mark.parametrize("tile", [4, 16, 128])
@pytest.mark.parametrize("win", [5, 97, 300])
def test_tiled_window_walk_on_random_traces(win, tile):
    """One window over random traces (synthetic.window_walk_cases): walks
    carried in above the window's last row (the last-row clamp), below
    its first (no walk), mid-byte, and off the band; the plain tiled walk
    equals walk_window_plain's (k, e, n) and bytes."""
    rng = np.random.default_rng(win * 10 + tile)
    y = synthetic.window_walk_cases(rng, 12, win, 40)
    u = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in y.items()}
    a = (u["trace"], u["llk"], 40, u["kst"], u["flat"], u["byte_off"])
    want = abea_ultra.walk_window_plain(*a)
    got = abea_ultra.walk_window_tiled_plain(*a, tile)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    k, e, n = (y["kst"][:, j].astype(np.int64) for j in range(3))
    v = e + k + 2 - 40
    walks = (k >= 0) & (e >= 0) & (v >= 0)
    assert (walks & (v >= win)).any()           # the clamp
    assert (~walks).any()                       # no walk
    assert (walks & (n % 4 != 0)).any()         # mid-byte

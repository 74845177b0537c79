"""The port's plain ABEA (f5c_tpu_torch/ops/abea.py) against the JAX
package, bit for bit: start event, walk length and the first n walk
directions (bytes past n are unspecified).

- the production Pallas ring kernel, abea_align_device_ring in interpret
  mode, at the __graft_entry__.entry() shape (one call);
- the XLA path abea.abea_fill + abea_backtrace_packed;
- the NumPy oracle abea_ref.align (align.c semantics).

The XLA and oracle cases use mixed read lengths: n_kmers below and above
128, reads short enough that their whole band straddles the trim column,
and one read whose events do not follow its sequence (it fails QC).  They
go through the wrappers, which take the sequences 2-bit packed and rank
them (K11) before the plain fill; at k = 5, 6 and 9 the four wrappers
give what the plain fills give on ranks_from_packed's ranks and on the
NumPy ranker's, on reads at every offset mod 4 of the packed buffer (the
ring kernel's case has ranks but no sequences, so it runs the plain fill
and walk on its ranks).

The tiled walk's plain version (abea_walk_tiled_plain: tile maps, chase,
emission) equals abea_walk_plain byte for byte and the JAX XLA walk on
the mixed reads and on the golden reads' launch (as the port's Pipeline
makes it on the CPU), at tiles of 4, 16 and 128 bands, and on random
traces whose paths leave the band (synthetic.walk_cases), where its
phases' records show every case: no walk, a walk of one tile, walks
over many tiles, the chase's cell-by-cell path.

The range in which the fill kernels take their fast quotient
(``fill_fast_division_ok``, the plain statement of the kernels' staging
vote): every golden read and every ultra x4 read (their launches as the
port's Pipeline makes them on the CPU) takes it, the far inputs of
``synthetic.abea_far_inputs`` (events of +-2^40, a stdv of 2^-70, a
shift of 2^31) do not, and on those the plain fill still equals the JAX
XLA fill cell for cell and walk for walk.
"""

import numpy as np
import pytest
import torch

from f5c_tpu.models import builtin_model
from f5c_tpu.ops.abea_ref import Scalings
from f5c_tpu_torch import synthetic
from f5c_tpu_torch.ops import (abea as port_abea, abea_cuda, abea_ultra,
                               abea_ultra_cuda)
from f5c_tpu_torch.ops.abea import band_offsets
from f5c_tpu_torch.ops.seq_ranks import ranks_from_packed

N_KMERS = [20, 45, 100, 127, 128, 129, 250, 400]
UNRELATED = 6


def _dirs(flat, off, n):
    """First n 2-bit walk directions of one read."""
    b = np.asarray(flat[off:off + (n + 3) // 4], np.uint8)
    d = np.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], 1)
    return d.reshape(-1)[:n]


TABLES = ("level_mean", "level_stdv", "level_log_stdv", "params",
          "band_off")


def _tensors(x: dict) -> dict:
    return {k: (torch.from_numpy(np.array(v))
                if isinstance(v, np.ndarray) else v) for k, v in x.items()}


def _run_port(x: dict):
    """The port's ABEA on ``x``: through abea_cuda.abea_align on the
    packed sequences where ``x`` has them, else (ranks only) the plain
    fill and walk on its ranks."""
    t = _tensors(x)
    if "seq_packed" in x:
        flat, start_e, n = abea_cuda.abea_align(
            *(t[k] for k in ("ev_pool", "ev_off", "ev_len", "seq_packed",
                             "seq_off", "rk_len", "k", *TABLES, "byte_off",
                             "n_bands", "n_bytes")))
    else:
        trace, llk, start_e = port_abea.abea_fill_plain(
            *(t[k] for k in ("ev_pool", "ev_off", "ev_len", "rk_pool",
                             "rk_off", "rk_len", *TABLES)))
        flat, n = port_abea.abea_walk_plain(trace, llk, t["band_off"],
                                            start_e, t["rk_len"],
                                            t["byte_off"])
    return flat.numpy(), start_e.numpy(), n.numpy()


@pytest.fixture(scope="module")
def mixed():
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(3)
    seqs, events = synthetic.abea_reads(rng, N_KMERS, model,
                                        unrelated=(UNRELATED,))
    B = len(seqs)
    scale = rng.uniform(0.97, 1.03, B).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    x = synthetic.abea_inputs(seqs, events, model, scale, shift)
    return model, seqs, events, scale, shift, x, _run_port(x)


def test_plain_matches_ring_kernel_interpret():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    flat_j, start_j, n_j = (np.asarray(a) for a in fn(*args))
    (ev, ev_off, ev_len, rk, rk_off, rk_len, lm, ls, ll, scale, shift,
     lp_stay, lp_step, lp_skip, lp_trim, off) = (np.asarray(a) for a in args)
    byte_off = off.astype(np.int64)
    band_off = band_offsets(ev_len, rk_len)
    flat, start_e, n = _run_port(dict(
        ev_pool=ev, ev_off=ev_off.astype(np.int64), ev_len=ev_len,
        rk_pool=rk, rk_off=rk_off.astype(np.int64), rk_len=rk_len,
        level_mean=lm, level_stdv=ls, level_log_stdv=ll,
        params=np.stack([scale, shift, lp_stay, lp_step, lp_skip, lp_trim],
                        axis=1),
        band_off=band_off, byte_off=byte_off, n_bands=int(band_off[-1]),
        n_bytes=int(byte_off[-1])))
    np.testing.assert_array_equal(start_e, start_j)
    np.testing.assert_array_equal(n, n_j)
    assert n.min() > 0
    for i in range(ev_len.shape[0]):
        np.testing.assert_array_equal(
            _dirs(flat, byte_off[i], n[i]), _dirs(flat_j, off[i], n_j[i]))


@pytest.fixture(scope="module")
def xla_fill(mixed):
    """The JAX package's XLA fill of the mixed reads: (batch, its output
    (trace u8 [B, n_bands, PAD], ll_event, ll_kmer, last_col), E, K)."""
    from f5c_tpu.ops import abea

    model, seqs, events, scale, shift, _x, _ = mixed
    ranks = [model.kmer_ranks(s) for s in seqs]
    scalings = [Scalings(shift=float(b), scale=float(a))
                for a, b in zip(scale, shift)]
    batch = abea.make_batch(events, ranks, model, scalings=scalings)
    E = batch.event_means.shape[1] - 2 * abea.PAD
    K = batch.kmer_mean.shape[1] - 2 * abea.PAD
    return batch, abea.abea_fill(batch, n_bands=E + K + 2), E, K


def test_plain_matches_xla_fill_and_walk(mixed, xla_fill):
    from f5c_tpu.ops import abea

    model, seqs, events, scale, shift, x, (flat, start_e, n) = mixed
    batch, fill, E, K = xla_fill
    packed, start_x, n_x, *_ = abea.abea_backtrace_packed(
        fill, batch, max_pairs=-(-(E + K) // 4) * 4)
    packed, start_x, n_x = (np.asarray(a) for a in (packed, start_x, n_x))
    np.testing.assert_array_equal(n, n_x)
    assert (n > 0).all()
    np.testing.assert_array_equal(start_e, start_x)
    for i in range(len(seqs)):
        np.testing.assert_array_equal(_dirs(flat, x["byte_off"][i], n[i]),
                                      _dirs(packed[i], 0, n_x[i]))


def test_packed_trace_matches_xla_fill(mixed, xla_fill):
    """The fill wrapper's trace (CPU: the plain fill) is TRACE_ROW_BYTES a
    band, and unpacked it is the JAX XLA fill's one-byte-a-cell trace,
    cell for cell over each read's bands; so are the lower-left k-mers."""
    _model, _seqs, _events, _scale, _shift, x, _ = mixed
    _batch, (trace_x, _ll_e, ll_k, _lc), _E, _K = xla_fill
    trace_x, ll_k = np.asarray(trace_x), np.asarray(ll_k)
    t = _tensors(x)
    trace, llk, _ = abea_cuda.abea_fill(
        *(t[k] for k in ("ev_pool", "ev_off", "ev_len", "seq_packed",
                         "seq_off", "rk_len", "k", *TABLES)), x["n_bands"])
    assert trace.shape == (x["n_bands"], port_abea.TRACE_ROW_BYTES) == (
        x["n_bands"], 32)
    dirs = port_abea.unpack_trace(trace).numpy()
    assert set(np.unique(dirs)) == {0, 1, 2}
    for i in range(len(x["rk_len"])):
        b0, b1 = int(x["band_off"][i]), int(x["band_off"][i + 1])
        np.testing.assert_array_equal(dirs[b0:b1], trace_x[i, :b1 - b0],
                                      err_msg=str(i))
        np.testing.assert_array_equal(llk[b0:b1].numpy(),
                                      ll_k[i, :b1 - b0], err_msg=str(i))


@pytest.mark.parametrize("lead", [(0,), (1,), (7,), (4, 13), (2, 0, 5)])
def test_pack_trace_round_trip(lead):
    """pack_trace / unpack_trace on seeded directions 0-2 (band counts
    that are not multiples of 4, empty reads), and trace_cell reads every
    cell of the packed rows as unpack_trace does."""
    rng = np.random.default_rng(sum(lead) + 5)
    dirs = torch.from_numpy(rng.integers(0, 3, (*lead, port_abea.PAD),
                                         dtype=np.uint8))
    rows = port_abea.pack_trace(dirs)
    assert rows.dtype == torch.uint8
    assert rows.shape == (*lead, port_abea.TRACE_ROW_BYTES)
    assert torch.equal(port_abea.unpack_trace(rows), dirs)
    flat_rows = rows.reshape(-1, port_abea.TRACE_ROW_BYTES)
    flat_dirs = dirs.reshape(-1, port_abea.PAD)
    r, o = torch.meshgrid(torch.arange(flat_rows.shape[0]),
                          torch.arange(port_abea.PAD), indexing="ij")
    assert torch.equal(port_abea.trace_cell(flat_rows, r, o),
                       flat_dirs.long())


def test_pack_trace_layout():
    """The bytes of one row as the kernels' ballots lay them out: warp w's
    8 bytes are bit 0 of cells 32w..32w+31 as a little-endian u32, then
    bit 1 of the same cells."""
    dirs = torch.zeros(port_abea.PAD, dtype=torch.uint8)
    dirs[[0, 33, 70, 127]] = torch.tensor([1, 2, 1, 2], dtype=torch.uint8)
    row = port_abea.pack_trace(dirs).numpy().view("<u4")
    assert row.tolist() == [1, 0, 0, 1 << 1, 1 << 6, 0, 0, 1 << 31]


def test_walks_refuse_a_byte_per_cell_trace(mixed):
    """The walk wrappers take the packed trace only."""
    _model, _seqs, _events, _scale, _shift, x, _ = mixed
    t = _tensors(x)
    trace = port_abea.unpack_trace(torch.zeros(
        (x["n_bands"], port_abea.TRACE_ROW_BYTES), dtype=torch.uint8))
    llk = torch.zeros(x["n_bands"], dtype=torch.int32)
    start_e = torch.zeros(len(x["rk_len"]), dtype=torch.int32)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        abea_cuda.abea_walk(trace, llk, t["band_off"], start_e, t["rk_len"],
                            t["byte_off"], x["n_bytes"])
    B = len(x["rk_len"])
    with pytest.raises(ValueError, match="inconsistent shapes"):
        abea_ultra_cuda.abea_walk_window(
            torch.zeros((B, 5, port_abea.PAD), dtype=torch.uint8),
            torch.zeros((B, 5), dtype=torch.int32), 2,
            torch.zeros((B, 3), dtype=torch.int32),
            torch.zeros(x["n_bytes"], dtype=torch.uint8), t["byte_off"])


def test_plain_matches_numpy_oracle(mixed):
    from f5c_tpu.ops.abea import decode_packed_dirs
    from f5c_tpu.ops.abea_ref import align

    model, seqs, events, scale, shift, x, (flat, start_e, n) = mixed
    n_failed = 0
    for i, (seq, ev) in enumerate(zip(seqs, events)):
        ref = align(seq, ev, model, Scalings(shift=float(shift[i]),
                                             scale=float(scale[i])))
        assert n[i] == ref.n_aligned, i
        n_failed += ref.failed
        if ref.failed:
            continue
        pairs = decode_packed_dirs(flat[x["byte_off"][i]:], int(n[i]),
                                   int(start_e[i]), int(x["rk_len"][i]))
        np.testing.assert_array_equal(pairs, ref.pairs, err_msg=str(i))
        assert start_e[i] == ref.pairs[-1, 1]
    assert n_failed == 1


@pytest.mark.parametrize("k", [5, 6, 9])
def test_wrappers_on_packed_seqs_match_the_ranked_path(k):
    """abea_fill, abea_align, abea_fill_window and abea_align_windowed on
    the packed sequences (CPU: K11's plain version, then the plain
    fills) give bit for bit what the plain fills give on the ranks of
    ranks_from_packed at the reads' base offsets and on the NumPy
    ranker's ranks; the reads start at every offset mod 4, one has Ns
    and one is exactly k long (synthetic.abea_rank_cases)."""
    model = synthetic.nucleotide_model(k)
    rng = np.random.default_rng(40 + k)
    seqs = synthetic.abea_rank_cases(rng, k)
    x = synthetic.abea_inputs(seqs, synthetic.kmer_events(rng, seqs, model),
                              model)
    t = _tensors(x)
    assert len(seqs[0]) == k and "N" in seqs[3]
    assert set(x["seq_off"] % 4) == {0, 1, 2, 3}
    head = [t[f] for f in ("ev_pool", "ev_off", "ev_len")]
    tables = [t[f] for f in TABLES]
    new = [*head, t["seq_packed"], t["seq_off"], t["rk_len"], k, *tables]
    ranked = [*head, ranks_from_packed(t["seq_packed"], k), t["seq_off"],
              t["rk_len"], *tables]
    numpy_ranked = [*head, t["rk_pool"], t["rk_off"], t["rk_len"], *tables]

    def same(got, *wants):
        # state records hold ints as f32 bits: compare every output's bits
        for want in wants:
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    if g.dtype == torch.float32:
                        g, w = g.view(torch.int32), w.view(torch.int32)
                    assert torch.equal(g, w)

    fill = port_abea.abea_fill_plain(*ranked)
    same(abea_cuda.abea_fill(*new, x["n_bands"]), fill,
         port_abea.abea_fill_plain(*numpy_ranked))
    flat, n = port_abea.abea_walk_plain(fill[0], fill[1], t["band_off"],
                                        fill[2], t["rk_len"], t["byte_off"])
    aligned = abea_cuda.abea_align(*new, t["byte_off"], x["n_bands"],
                                   x["n_bytes"])
    same(aligned, (flat, fill[2], n))
    assert int((n > 0).sum()) >= len(seqs) - 1

    nb_max = int(np.diff(x["band_off"]).max())
    win = 37
    nw = abea_ultra.n_windows(nb_max, win)
    s0 = abea_ultra.initial_state(t["params"])
    for base, n_win, trace in ((2, nw, False), (2 + win, 1, True)):
        same(abea_ultra_cuda.abea_fill_window(*new, s0, base, win, n_win,
                                              trace),
             abea_ultra.fill_window_plain(*ranked, s0, base, win, n_win,
                                          trace),
             abea_ultra.fill_window_plain(*numpy_ranked, s0, base, win,
                                          n_win, trace))
    same(abea_ultra_cuda.abea_align_windowed(
        *new, t["byte_off"], x["n_bytes"], nb_max, win), aligned,
        abea_ultra.align_windowed(*ranked, t["byte_off"], x["n_bytes"],
                                  nb_max, win))


@pytest.fixture(scope="module")
def golden_batch(tmp_path_factory):
    """The golden reads' ABEA launch as the port's Pipeline makes it on the
    CPU (its abea_align arguments), and the same reads as the JAX
    package's XLA fill takes them, with that fill."""
    import io
    import os

    from test_golden_e2e import GOLDEN

    from f5c_tpu.ops import abea
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.pipeline.runner import Options, Pipeline

    tmp = str(tmp_path_factory.mktemp("golden_walk"))
    datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB), tmp)
    calls = []
    align = abea_cuda.abea_align

    def spy(*a, **kw):
        calls.append(a)
        return align(*a, **kw)

    opt = Options(min_mapq=0, meth_out_version=1,
                  slow5_path=os.path.join(tmp, "signals.blow5"))
    pipe = Pipeline(os.path.join(tmp, "reads.bam"),
                    os.path.join(tmp, "genome.fa"),
                    os.path.join(tmp, "reads.fasta"), opt,
                    device=torch.device("cpu"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(abea_cuda, "abea_align", spy)
        pipe.call_methylation(out=io.StringIO())
    (ev_pool, ev_off, ev_len, seq_packed, seq_off, rk_len, k, lm, ls, lls,
     params, band_off, byte_off, n_bands, n_bytes, *_) = calls[0]
    x = dict(ev_pool=ev_pool, ev_off=ev_off, ev_len=ev_len,
             rk_pool=ranks_from_packed(seq_packed, k), rk_off=seq_off,
             rk_len=rk_len, level_mean=lm, level_stdv=ls,
             level_log_stdv=lls, params=params, band_off=band_off,
             byte_off=byte_off)
    model = builtin_model("dna_r9_nucleotide")
    B = ev_len.shape[0]
    events = [ev_pool[ev_off[i]:ev_off[i] + ev_len[i]].numpy()
              for i in range(B)]
    ranks = [x["rk_pool"][seq_off[i]:seq_off[i] + rk_len[i]].numpy()
             for i in range(B)]
    scalings = [Scalings(shift=float(params[i, 1]),
                         scale=float(params[i, 0])) for i in range(B)]
    batch = abea.make_batch(events, ranks, model, scalings=scalings)
    E = batch.event_means.shape[1] - 2 * abea.PAD
    K = batch.kmer_mean.shape[1] - 2 * abea.PAD
    return x, batch, abea.abea_fill(batch, n_bands=E + K + 2), E, K


def _plain_fill(x):
    t = _tensors(x)
    return port_abea.abea_fill_plain(*(t[k] for k in (
        "ev_pool", "ev_off", "ev_len", "rk_pool", "rk_off", "rk_len",
        *TABLES)))


@pytest.mark.parametrize("tile", [4, 16, 128])
@pytest.mark.parametrize("which", ["mixed", "golden"])
def test_tiled_walk_matches_plain_and_xla(request, which, tile):
    """abea_walk_tiled_plain (maps, chase, emission) on the plain fill of
    the mixed reads and of the golden reads equals abea_walk_plain byte
    for byte (directions, n, every byte up to each read's cap) and the
    JAX XLA walk's first n directions, at tiles of 4, 16 and 128 bands:
    paths cross many tile edges by one-band and two-band steps, and
    reads of 128 bands or fewer are one tile."""
    from f5c_tpu.ops import abea

    if which == "mixed":
        _model, _s, _e, _a, _b, x, _ = request.getfixturevalue("mixed")
        batch, fill, E, K = request.getfixturevalue("xla_fill")
    else:
        x, batch, fill, E, K = request.getfixturevalue("golden_batch")
    t = _tensors(x)
    trace, llk, start_e = _plain_fill(x)
    args = (trace, llk, t["band_off"], start_e, t["rk_len"], t["byte_off"])
    flat, n = port_abea.abea_walk_plain(*args)
    got_flat, got_n = port_abea.abea_walk_tiled_plain(*args, tile)
    assert torch.equal(got_n, n) and torch.equal(got_flat, flat)
    packed, start_x, n_x, *_ = abea.abea_backtrace_packed(
        fill, batch, max_pairs=-(-(E + K) // 4) * 4)
    packed, n_x = np.asarray(packed), np.asarray(n_x)
    np.testing.assert_array_equal(got_n.numpy(), n_x)
    np.testing.assert_array_equal(start_e.numpy(), np.asarray(start_x))
    nb = np.diff(np.asarray(x["band_off"]))
    assert (nb > 4 * tile).any() or tile == 128
    for i in range(len(n_x)):
        np.testing.assert_array_equal(
            _dirs(got_flat.numpy(), int(x["byte_off"][i]), int(n_x[i])),
            _dirs(packed[i], 0, int(n_x[i])))


@pytest.mark.parametrize("tile", [4, 16, 128])
def test_tiled_walk_phases_on_random_traces(tile):
    """On random traces (synthetic.walk_cases), whose paths leave the
    band: the three plain phases equal abea_walk_plain byte for byte,
    and the cases are all there -- a read that does not walk
    (start_e = -1: no tile visited), a walk of one tile, walks that end
    inside a tile below their start's, and paths that leave a tile
    outside the mapped cells (chased cell by cell)."""
    rng = np.random.default_rng(60 + tile)
    x = _tensors(synthetic.walk_cases(
        rng, [3, 40, 128, 129, 300, 1000, 2600, 90]))
    args = tuple(x[k] for k in ("trace", "llk", "band_off", "start_e",
                                "rk_len", "byte_off"))
    want = port_abea.abea_walk_plain(*args)
    got = port_abea.abea_walk_tiled_plain(*args, tile)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    bo = x["band_off"]
    ok = x["start_e"] >= 0
    view = port_abea.tiled_view(
        bo[:-1], bo[1:] - bo[:-1], 0,
        torch.where(ok, x["rk_len"].long() - 1, -1),
        torch.where(ok, x["start_e"].long(), -1), torch.zeros_like(bo[:-1]),
        x["byte_off"][:-1], x["byte_off"][1:] - x["byte_off"][:-1], tile)
    maps, start = port_abea.walk_tiled_maps(x["trace"], x["llk"], view)
    ent, span = port_abea.walk_tiled_chase(x["trace"], x["llk"], view, maps,
                                           start)
    j_end, j_s = span[:, 0], span[:, 1]
    assert (j_end > j_s).any()                      # no walk
    assert ((j_end == j_s) & ok).any()              # one tile
    assert (j_end < j_s).any()                      # many tiles
    starts = view["tile_off"][:-1] + j_s.clamp(min=0)
    exact = ent[:, 0] == port_abea.ENT_EXACT
    exact[starts[j_s >= 0]] = False
    assert exact.any()                              # the cell-by-cell chase
    assert ((start[:, 0] & port_abea.MAP_STOP) != 0).any()


def _abea_launches(data: dict) -> list:
    """The arguments of every unchunked ABEA launch (abea_align) of a
    call-methylation run of the port's Pipeline on the CPU over ``data``,
    each answered with every read unaligned (start_e -1), so that the run
    goes on without filling."""
    import io

    from f5c_tpu_torch.pipeline.runner import Options, Pipeline

    got = []

    def spy(*a, **kw):
        got.append(a)
        B = a[2].shape[0]
        return (torch.zeros(a[-2], dtype=torch.uint8),
                torch.full((B,), -1, dtype=torch.int32),
                torch.zeros(B, dtype=torch.int32))

    opt = Options(min_mapq=0, meth_out_version=1, slow5_path=data["slow5"])
    pipe = Pipeline(data["bam"], data["genome"], data["reads"], opt,
                    device=torch.device("cpu"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(abea_cuda, "abea_align", spy)
        pipe.call_methylation(out=io.StringIO())
    return got


def test_fill_fast_division_routes(tmp_path):
    """Every golden read and every read of ultra x4 (4 reads of 100-300
    kb: a wave's launch and ul300's solo launch at the defaults) stays in
    the fast quotient's range; of the far inputs exactly the reads
    outside it leave it."""
    from test_golden_e2e import GOLDEN

    from f5c_tpu_torch import datasets

    golden = datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB),
        str(tmp_path / "golden"))
    ultra = datasets.ultra_dataset(str(tmp_path / "ultra"), seed=2026)
    for data, n_reads in ((golden, 6), (ultra, 4)):
        launched = _abea_launches(data)
        assert sum(args[2].shape[0] for args in launched) == n_reads
        for args in launched:
            assert port_abea.fill_routes(*args[:12]).all()
    x = _tensors(synthetic.abea_far_inputs(
        np.random.default_rng(19), builtin_model("dna_r9_nucleotide")))
    routes = port_abea.fill_routes(*(x[k] for k in (
        "ev_pool", "ev_off", "ev_len", "seq_packed", "seq_off", "rk_len",
        "k", *TABLES)))
    np.testing.assert_array_equal(routes, x["fast"].numpy())
    assert not routes.all() and routes.any()
    ev = torch.tensor([0.0, 2.0 ** -30, -(2.0 ** 30) * 0.99, 95.0])
    assert port_abea.fill_fast_division_ok(ev, ev, torch.ones(4))
    for bad_ev, bad_sd in ((2.0 ** 30, 1.0), (2.0 ** -31, 1.0),
                           (1.0, 0.0), (1.0, 2.0 ** -61), (1.0, 2.0 ** 60),
                           (float("inf"), 1.0), (float("nan"), 1.0)):
        assert not port_abea.fill_fast_division_ok(
            torch.tensor([bad_ev]), torch.tensor([1.0]),
            torch.tensor([bad_sd]))


def test_plain_matches_xla_fill_on_far_inputs():
    """The far inputs (synthetic.abea_far_inputs), where the kernels take
    __fdiv_rn: the port's plain fill, unpacked, is the JAX XLA fill's
    trace cell for cell with its lower-left k-mers, and the walks agree
    (start event, length, directions)."""
    import dataclasses

    from f5c_tpu.ops import abea

    model = builtin_model("dna_r9_nucleotide")
    x = synthetic.abea_far_inputs(np.random.default_rng(19),
                                  builtin_model("dna_r9_nucleotide"))
    far_model = dataclasses.replace(model, level_stdv=x["level_stdv"])
    np.testing.assert_array_equal(far_model.level_log_stdv,
                                  x["level_log_stdv"])
    B = x["ev_len"].shape[0]
    events = [x["ev_pool"][x["ev_off"][i]:x["ev_off"][i] + x["ev_len"][i]]
              for i in range(B)]
    ranks = [x["rk_pool"][x["rk_off"][i]:x["rk_off"][i] + x["rk_len"][i]]
             for i in range(B)]
    scalings = [Scalings(shift=float(x["params"][i, 1]),
                         scale=float(x["params"][i, 0])) for i in range(B)]
    batch = abea.make_batch(events, ranks, far_model, scalings=scalings)
    E = batch.event_means.shape[1] - 2 * abea.PAD
    K = batch.kmer_mean.shape[1] - 2 * abea.PAD
    fill = abea.abea_fill(batch, n_bands=E + K + 2)
    trace_x, ll_k = np.asarray(fill[0]), np.asarray(fill[2])
    t = _tensors(x)
    trace, llk, start_e = abea_cuda.abea_fill(
        *(t[k] for k in ("ev_pool", "ev_off", "ev_len", "seq_packed",
                         "seq_off", "rk_len", "k", *TABLES)), x["n_bands"])
    dirs = port_abea.unpack_trace(trace).numpy()
    for i in range(B):
        b0, b1 = int(x["band_off"][i]), int(x["band_off"][i + 1])
        np.testing.assert_array_equal(dirs[b0:b1], trace_x[i, :b1 - b0],
                                      err_msg=str(i))
        np.testing.assert_array_equal(llk[b0:b1].numpy(),
                                      ll_k[i, :b1 - b0], err_msg=str(i))
    packed, start_x, n_x, *_ = abea.abea_backtrace_packed(
        fill, batch, max_pairs=-(-(E + K) // 4) * 4)
    packed, start_x, n_x = (np.asarray(a) for a in (packed, start_x, n_x))
    flat, n = port_abea.abea_walk_plain(trace, llk, t["band_off"], start_e,
                                        t["rk_len"], t["byte_off"])
    np.testing.assert_array_equal(start_e.numpy(), start_x)
    np.testing.assert_array_equal(n.numpy(), n_x)
    for i in range(B):
        np.testing.assert_array_equal(
            _dirs(flat.numpy(), x["byte_off"][i], int(n[i])),
            _dirs(packed[i], 0, int(n_x[i])))

"""f5c-tpu-torch command line: ``index``, ``call-methylation``,
``eventalign``, ``resquiggle``, ``meth-freq``, ``freq-merge`` and
``fast5-to-blow5``, the device steps on a CUDA card.

    python -m f5c_tpu_torch.cli index reads.fasta [--slow5 signals.blow5]
        [-d fast5_dir ...] [-s sequencing_summary.txt ...] [--iop N]
    python -m f5c_tpu_torch.cli call-methylation -b reads.bam -g genome.fa \\
        -r reads.fasta --slow5 signals.blow5 [-o out.tsv] \\
        [--meth-out-version {1,2}] [--device {cuda,cpu}] [--profile-dir DIR]
    python -m f5c_tpu_torch.cli eventalign -b reads.bam -g genome.fa \\
        -r reads.fasta --slow5 signals.blow5 [-o out.tsv] \\
        [--summary summary.tsv] [--sam | --paf | --m6anet] [--device ...]
    python -m f5c_tpu_torch.cli resquiggle reads.fastq --slow5 signals.blow5
        [-c] [-o out.tsv] [--device ...]
    python -m f5c_tpu_torch.cli meth-freq -i meth.tsv [-c 2.5] [-s] [-o out]
    python -m f5c_tpu_torch.cli freq-merge freq1.tsv freq2.tsv ... [-o out]
    python -m f5c_tpu_torch.cli fast5-to-blow5 -d fast5_dir -o out.blow5

The options are the JAX package's (``f5c_tpu/cli.py``: its option
tables, copied here); ``--device`` selects the torch device and
``--events-engine`` where events are detected (``host``: the native
detector; ``device``: the event kernels, or with ``--device cpu`` their
plain version; ``auto``: ``host``).  The default device is ``cuda`` and a
run with no card is an error: ``--device cpu`` is the explicit request
for the kernels' plain PyTorch versions on the host.  ``index``,
``meth-freq``, ``freq-merge`` and ``fast5-to-blow5`` run on the host
only.  ``--profile-dir DIR`` writes a torch.profiler trace of a
call-methylation or eventalign run to DIR (TensorBoard layout; the card's
activity, or the host's with ``--device cpu``), with the pipeline's spans
(``pipeline/spans.py``) on the trace's time base.  ``--dist -o FILE`` runs
call-methylation or eventalign as one rank of several processes
(``parallel/distributed.py``: a gloo group; the launch is found as the
JAX package finds it, the ``--dist-*`` options first, then Open MPI or
SLURM, or torchrun);
each rank writes its read shard to ``FILE.partN`` and rank 0 merges the
parts into the single-process bytes.  Several visible cards are used
as a mesh (``parallel/mesh.py``; ``F5C_TPU_MESH=0`` turns it off).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

__version__ = "0.1.0"


def _add_common_meth_args(p):
    p.add_argument("-b", "--bam", required=True, help="sorted BAM file")
    p.add_argument("-g", "--genome", required=True, help="reference genome FASTA")
    p.add_argument("-r", "--reads", required=True, help="reads FASTA/FASTQ")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="host worker processes")
    p.add_argument("-K", "--batchsize", type=int, default=None,
                   help="max reads per batch [512]")
    p.add_argument("-B", "--max-bases", type=_kmg, default=None,
                   help="max bases per batch (K/M/G suffixes ok) [5M]")
    p.add_argument("-x", "--profile", default=None,
                   help="parameter preset (laptop/desktop/hpc/tpu/... or "
                        "a file of 7 numbers), applied before other flags")
    p.add_argument("-w", "--window", default=None,
                   help="genomic region chr:start-end or a .bed file")
    p.add_argument("--ultra-thresh", type=_kmg, default=100_000,
                   help="threshold for ultra-long reads")
    p.add_argument("--skip-ultra", default=None, metavar="FILE",
                   help="skip ultra-long reads, writing them to FILE (BAM) "
                        "for a second pass")
    p.add_argument("--min-mapq", type=int, default=20)
    p.add_argument("--slow5", help="SLOW5/BLOW5 signal file (instead of "
                   "FAST5 via the readdb index)")
    p.add_argument("--secondary", choices=["yes", "no"], default="no")
    p.add_argument("--rna", action="store_true", help="direct RNA data")
    p.add_argument("--pore", choices=["r9", "r10", "rna004"], default="r9")
    p.add_argument("--kmer-model", help="custom nucleotide model file")
    p.add_argument("--meth-model", help="custom methylation model file")
    p.add_argument("--min-recalib-events", type=int, default=200,
                   help="min events to attempt recalibration")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels (an "
                        "error without a card); 'cpu' runs their plain "
                        "PyTorch versions")
    _add_events_engine_arg(p)
    p.add_argument("-o", "--output", default="-", help="output file")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process only reads with read_idx %% N == I "
                        "(multi-host data parallelism; merge outputs "
                        "with cat / freq-merge)")
    p.add_argument("--dist", action="store_true",
                   help="multi-process mode over torch.distributed (a "
                        "gloo group): each process takes its read shard, "
                        "writes <output>.partN, and process 0 merges to "
                        "the exact single-process output (requires -o "
                        "FILE)")
    p.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address (rank 0 listens) for manual "
                        "--dist launches; what the --dist-* options leave "
                        "out is auto-detected under Open MPI and SLURM, "
                        "and with none given torchrun's env:// variables "
                        "are read")
    p.add_argument("--dist-rank", type=int, default=None,
                   help="this process's rank for manual --dist launches")
    p.add_argument("--dist-nprocs", type=int, default=None,
                   help="total process count for manual --dist launches")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR "
                        "(view with TensorBoard), with the pipeline's "
                        "spans; every span of the run is kept in memory "
                        "until it ends (~170 B a span, thousands a "
                        "second on a card), so profile a short run")
    p.add_argument("--print-events", action="store_true",
                   help="dump the event table (debug oracle)")
    p.add_argument("--print-banded-aln", action="store_true",
                   help="dump ABEA aligned pairs (debug oracle)")
    p.add_argument("--print-raw", action="store_true",
                   help="print the raw ADC signal of each read at load "
                        "(debug; forces single-process BAM-ordered loads)")
    p.add_argument("--skip-unreadable", choices=["yes", "no"],
                   default="yes",
                   help="skip unreadable signal records with a counter "
                        "(yes) or abort (no)")
    p.add_argument("--write-dump", default=None, metavar="FILE",
                   help="cache raw signals to FILE while loading "
                        "(reference binary dump format)")
    p.add_argument("--read-dump", default=None, metavar="FILE",
                   help="load raw signals from a --write-dump cache "
                        "instead of FAST5/SLOW5 (same BAM + filters)")
    p.add_argument("--debug-break", type=int, default=-1, metavar="N",
                   help="stop after processing N batches (debug)")
    p.add_argument("--profile-cpu", choices=["yes", "no"], default="no",
                   help="print the per-component stage breakdown at exit "
                        "(stage timing is always on; this adds "
                        "host/transfer/dispatch detail)")
    p.add_argument("--print-scaling", action="store_true",
                   help="dump calibrated scalings (debug oracle)")
    p.add_argument("--verbose", type=int, default=0)
    _add_cuda_compat_args(p)


def _add_events_engine_arg(p) -> None:
    p.add_argument("--events-engine", choices=["auto", "host", "device"],
                   default="auto",
                   help="event-detection engine: the host C++ detector or "
                        "the batched detector on the --device (CUDA "
                        "kernels, or their plain version on the cpu); "
                        "auto: host, as measured on an H100 (PERF.md)")


def _add_cuda_compat_args(p, full=True):
    """Accept the reference's CUDA tuning knobs (meth_main.c:76-84) so
    f5c command lines are drop-in; they have no effect yet, and main()
    warns when one is given."""
    g = p.add_argument_group("CUDA compatibility (accepted, no effect)")
    g.add_argument("--disable-cuda", choices=["yes", "no"], default=None,
                   help="no effect (use --device cpu for the host)")
    g.add_argument("--cuda-dev-id", default=None, help=argparse.SUPPRESS)
    g.add_argument("--cuda-mem-frac", default=None, help=argparse.SUPPRESS)
    if full:
        g.add_argument("--cuda-block-size", default=None,
                       help=argparse.SUPPRESS)
        g.add_argument("--cuda-max-lf", default=None, help=argparse.SUPPRESS)
        g.add_argument("--cuda-avg-epk", default=None, help=argparse.SUPPRESS)
        g.add_argument("--cuda-max-epk", default=None, help=argparse.SUPPRESS)


def _kmg(s: str) -> int:
    mult = {"k": 10**3, "m": 10**6, "g": 10**9}
    if s and s[-1].lower() in mult:
        return int(float(s[:-1]) * mult[s[-1].lower()])
    return int(s)


def _out_fh(spec):
    return sys.stdout if spec in ("-", None) else open(spec, "w")


def _make_pipeline(args, device):
    """Options as the JAX package's ``_make_pipeline`` builds them
    (f5c_tpu/cli.py:144-193), with the port's Pipeline."""
    from .pipeline.runner import Options, Pipeline

    opt = Options(
        min_mapq=args.min_mapq,
        keep_secondary=args.secondary == "yes",
        meth_out_version=getattr(args, "meth_out_version", 2),
        rna=args.rna,
        pore=args.pore,
        kmer_model_path=args.kmer_model,
        meth_model_path=args.meth_model,
        min_num_events_to_rescale=args.min_recalib_events,
        device=args.device,
        slow5_path=args.slow5,
        verbose=args.verbose,
        events_engine=args.events_engine,
    )
    if args.profile:
        from .profiles import apply_profile

        apply_profile(opt, args.profile)
    # explicit flags override the profile (profiles.c: -x applied first)
    if args.batchsize is not None:
        opt.batch_reads = args.batchsize
    if args.max_bases is not None:
        opt.batch_bases = args.max_bases
    if args.threads:
        opt.num_proc = args.threads
    opt.region_str = args.window
    opt.print_events = args.print_events
    opt.print_raw = args.print_raw
    opt.skip_unreadable = args.skip_unreadable != "no"
    opt.debug_break = args.debug_break
    opt.write_dump = args.write_dump
    opt.read_dump = args.read_dump
    opt.profile_detail = args.profile_cpu == "yes"
    opt.print_banded_aln = args.print_banded_aln
    opt.print_scaling = args.print_scaling
    if args.shard:
        i, n = args.shard.split("/")
        opt.shard_index, opt.shard_count = int(i), int(n)
    opt.dist_markers = args.dist
    opt.ultra_thresh = args.ultra_thresh
    opt.skip_ultra = args.skip_ultra
    return Pipeline(args.bam, args.genome, args.reads, opt, device)


def _add_eventalign_args(p) -> None:
    """The JAX CLI's eventalign options (f5c_tpu/cli.py:248-261)."""
    p.add_argument("--summary", help="write per-read summary TSV")
    p.add_argument("--sam", action="store_true")
    p.add_argument("--sam-out-version", type=int, choices=[1, 2], default=2,
                   help="SAM output: 1 = events-as-CIGAR record, 2 = base "
                        "alignment + si/ss/sc/sh tags")
    p.add_argument("--paf", action="store_true")
    p.add_argument("--m6anet", action="store_true")
    p.add_argument("--scale-events", action="store_true")
    p.add_argument("--samples", action="store_true")
    p.add_argument("--signal-index", action="store_true")
    p.add_argument("--collapse-events", action="store_true")
    p.add_argument("--print-read-names", action="store_true")


def _add_resquiggle_args(p) -> None:
    """The JAX CLI's resquiggle table (f5c_tpu/cli.py:280-303), with the
    port's --device."""
    p.add_argument("reads", help="reads FASTA/FASTQ")
    _add_events_engine_arg(p)
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--fast5-dir", action="append", default=[],
                   help="FAST5 directory (repeatable)")
    p.add_argument("--slow5", help="SLOW5/BLOW5 signal file")
    p.add_argument("--rna", action="store_true")
    p.add_argument("--pore", choices=["r9", "r10", "rna004"], default="r9")
    p.add_argument("--kmer-model")
    p.add_argument("-t", "--threads", type=int, default=None)
    p.add_argument("-K", "--batchsize", type=int, default=512)
    p.add_argument("-B", "--max-bases", type=_kmg, default=None,
                   help="max bases per batch (compat; resquiggle batches "
                        "by read count)")
    p.add_argument("-x", "--profile", default=None,
                   help="parameter preset (see call-methylation -x)")
    p.add_argument("-c", "--paf", action="store_true",
                   help="PAF output with ss string (default TSV)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels (an "
                        "error without a card); 'cpu' runs their plain "
                        "PyTorch versions")
    p.add_argument("-o", "--output", default="-")
    _add_cuda_compat_args(p, full=False)


def _dist_fail_note(dist_rank) -> None:
    """A failed --dist rank does not merge partial parts: it says so and
    leaves the group, and its peers error out of the barrier (at once, or
    at the timeout)."""
    if dist_rank is not None:
        from .parallel import distributed

        print(f"[f5c-tpu] rank {dist_rank} failed before the output "
              "barrier; part files are left unmerged and peer ranks "
              "will error out of the barrier.", file=sys.stderr)
        distributed.shutdown()


def _dist_start(ap, args, timeout_s: float):
    """--dist: check the options (the JAX CLI's refusals, exit 2), join
    the process group before the device is resolved, and retarget -o and
    --summary at this rank's part files.  Returns (rank, nprocs, the
    outputs to merge)."""
    if args.output in ("-", None):
        ap.error("--dist requires -o FILE (per-process part files "
                 "are merged into it)")
    if (args.print_events or args.print_banded_aln or args.print_scaling
            or args.print_raw):
        # debug dumps carry no per-read merge markers, so the k-way
        # part merge would drop or misplace them
        ap.error("--dist is incompatible with --print-* debug "
                 "dumps; run them single-process")
    if args.write_dump or args.read_dump:
        # the raw dump is a single sequential file in full-BAM order:
        # ranks would clobber it on write and mis-assign records on read
        ap.error("--dist is incompatible with --write-dump/"
                 "--read-dump; create/use dumps single-process")
    from .parallel import distributed

    try:
        rank, nprocs = distributed.initialize(
            args.dist_coordinator, args.dist_nprocs, args.dist_rank,
            timeout_s=timeout_s)
    except ValueError as e:
        ap.error(str(e))
    args.shard = f"{rank}/{nprocs}"
    outputs = [args.output]
    args.output = distributed.part_path(args.output, rank)
    if getattr(args, "summary", None):
        outputs.append(args.summary)
        args.summary = distributed.part_path(args.summary, rank)
    return rank, nprocs, outputs


@contextlib.contextmanager
def _maybe_profile(args, device, spans):
    """torch.profiler trace context for --profile-dir (the counterpart of
    the JAX package's jax.profiler trace, f5c_tpu/cli.py:210-220): the
    card's kernels and copies on a CUDA device, the host's operators with
    --device cpu, written in TensorBoard's layout when the run ends, with
    the spans the pipeline's recorder ``spans`` kept meanwhile."""
    d = getattr(args, "profile_dir", None)
    if not d:
        yield
        return
    import socket

    from torch.profiler import ProfilerActivity, profile

    from .pipeline.spans import add_to_chrome_trace

    def ready(prof):
        spans.stop()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{socket.gethostname()}_{os.getpid()}."
                               f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        add_to_chrome_trace(path, spans)

    activity = (ProfilerActivity.CUDA if device.type == "cuda"
                else ProfilerActivity.CPU)
    with profile(activities=[activity], on_trace_ready=ready):
        spans.start()
        yield


def _index(args) -> int:
    from .io.readdb import ReadDB

    t0 = time.time()
    db = ReadDB(args.reads)
    db.build(fast5_dirs=args.directory or None, slow5_path=args.slow5,
             sequencing_summary=args.summary or None, iop=args.iop)
    if args.slow5:
        from .io.slow5 import Slow5File

        Slow5File(args.slow5).close()   # builds <file>.idx
    print(f"[f5c-tpu-torch index] indexed {len(db._fa.entries)} reads "
          f"({len(db._paths or {})} with signal paths) "
          f"in {time.time()-t0:.1f}s", file=sys.stderr)
    return 0


def _fast5_to_blow5(args) -> int:
    from .io.fast5 import Fast5File
    from .io.slow5 import Slow5File, write_blow5

    t0 = time.time()

    def signals():
        for d in args.directory:
            for root, _dirs, files in os.walk(d):
                for fn in sorted(files):
                    if not fn.endswith(".fast5"):
                        continue
                    try:
                        with Fast5File(os.path.join(root, fn)) as f5:
                            for rid in f5.read_ids():
                                yield f5.get_signal(rid)
                    except OSError as e:
                        print(f"[f5c-tpu-torch] skipping {fn}: {e}",
                              file=sys.stderr)

    write_blow5(args.output, signals())
    Slow5File(args.output).close()   # build the .idx
    n_idx = len(Slow5File(args.output,
                          create_index_if_missing=False).read_ids())
    print(f"[f5c-tpu-torch] wrote {n_idx} reads to {args.output} "
          f"(+.idx) in {time.time()-t0:.1f}s", file=sys.stderr)
    return 0


def _meth_freq(args) -> int:
    from .pipeline.freq import meth_freq

    fh = sys.stdin if args.input == "-" else open(args.input)
    out = _out_fh(args.output)
    try:
        meth_freq(fh, call_threshold=args.call_threshold,
                  split_groups=args.split_groups, out=out)
    finally:
        if fh is not sys.stdin:
            fh.close()
        if out is not sys.stdout:
            out.close()
    return 0


def _freq_merge(args) -> int:
    from .pipeline.freq import freq_merge

    out = _out_fh(args.output)
    try:
        freq_merge(args.inputs, out=out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def main(argv=None, dist_timeout_s: float = 3600) -> int:
    """The command line; ``dist_timeout_s`` bounds --dist's rendezvous and
    barriers (the JAX package's hour by default)."""
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(
        prog="f5c-tpu-torch",
        description="nanopore signal analysis on PyTorch and CUDA "
                    "(index / call-methylation / eventalign / resquiggle / "
                    "meth-freq / freq-merge / fast5-to-blow5)")
    ap.add_argument("--version", action="version",
                    version=f"f5c-tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("index", help="build read index (readdb)")
    p.add_argument("reads", help="reads FASTA/FASTQ")
    p.add_argument("-d", "--directory", action="append", default=[],
                   help="FAST5 directory (repeatable)")
    p.add_argument("--slow5", help="SLOW5/BLOW5 signal file")
    p.add_argument("-s", "--summary", action="append", default=[],
                   help="basecaller sequencing summary (repeatable; "
                        "avoids the FAST5 scan)")
    p.add_argument("--iop", type=int, default=1,
                   help="parallel FAST5 scan processes")
    p = sub.add_parser("call-methylation", help="CpG methylation calling")
    _add_common_meth_args(p)
    p.add_argument("--meth-out-version", type=int, choices=[1, 2], default=2)
    p = sub.add_parser("eventalign", help="signal-to-reference alignment")
    _add_common_meth_args(p)
    _add_eventalign_args(p)
    p = sub.add_parser("fast5-to-blow5",
                       help="convert FAST5 files to one BLOW5 "
                            "(zlib records + svb-zd signals)")
    p.add_argument("-d", "--directory", action="append", required=True,
                   help="FAST5 directory (repeatable)")
    p.add_argument("-o", "--output", required=True, help="output .blow5")
    p = sub.add_parser("meth-freq", help="per-site methylation frequency")
    p.add_argument("-i", "--input", default="-")
    p.add_argument("-c", "--call-threshold", type=float, default=2.5)
    p.add_argument("-s", "--split-groups", action="store_true")
    p.add_argument("-o", "--output", default="-")
    p = sub.add_parser("freq-merge", help="merge meth-freq outputs")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", default="-")
    p = sub.add_parser("resquiggle", help="signal-to-read alignment")
    _add_resquiggle_args(p)
    args = ap.parse_args(argv)

    host_only = {"index": _index, "fast5-to-blow5": _fast5_to_blow5,
                 "meth-freq": _meth_freq, "freq-merge": _freq_merge}
    if args.cmd in host_only:
        return host_only[args.cmd](args)
    knobs = [n for n in ("disable_cuda", "cuda_dev_id", "cuda_mem_frac",
                         "cuda_block_size", "cuda_max_lf", "cuda_avg_epk",
                         "cuda_max_epk") if getattr(args, n, None) is not None]
    if knobs:
        print("f5c-tpu-torch: warning: --"
              + ", --".join(n.replace("_", "-") for n in knobs)
              + ": accepted for f5c compatibility, no effect",
              file=sys.stderr)

    dist_rank = None
    if getattr(args, "dist", False):
        from .parallel import distributed

        dist_rank, dist_nprocs, dist_outputs = _dist_start(ap, args,
                                                           dist_timeout_s)
    try:
        code, pipe = _run(args)
    except BaseException:
        _dist_fail_note(dist_rank)
        raise
    if code:
        _dist_fail_note(dist_rank)
        return code
    if dist_rank is not None:
        distributed.finalize(dist_outputs, dist_rank, dist_nprocs)
    return pipe.report() if pipe is not None else code


def _run(args):
    """A device subcommand: (exit code, the pipeline of a call-methylation
    or eventalign run once its output is closed, else None).  The code is
    2 for a device or engine the run cannot take; a pipeline's report
    comes after a --dist merge, as in the JAX CLI."""
    from .backend import resolve_device

    try:
        device = resolve_device(args.device)
        if args.cmd == "eventalign":
            from .pipeline.eventalign import engine_name

            engine_name(device)
    except (RuntimeError, ValueError) as e:
        print(f"f5c-tpu-torch: error: {e}", file=sys.stderr)
        return 2, None
    if args.cmd == "resquiggle":
        from .pipeline.resquiggle import run_resquiggle

        out = _out_fh(args.output)
        try:
            pipe = run_resquiggle(args, device, out=out)
        finally:
            if out is not sys.stdout:
                out.close()
        pipe.report()
        return 0, None
    pipe = _make_pipeline(args, device)
    out = _out_fh(args.output)
    try:
        with _maybe_profile(args, device, pipe.spans):
            if args.cmd == "eventalign":
                from .pipeline.eventalign import run_eventalign

                run_eventalign(pipe, args, out=out)
            else:
                pipe.call_methylation(out=out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0, pipe


if __name__ == "__main__":
    sys.exit(main())

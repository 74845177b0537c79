"""f5c-tpu-torch command line: ``call-methylation`` on a CUDA card.

    python -m f5c_tpu_torch.cli call-methylation -b reads.bam -g genome.fa \\
        -r reads.fasta --slow5 signals.blow5 [-o out.tsv] \\
        [--meth-out-version {1,2}] [--device {cuda,cpu}]

The options are the JAX package's (``f5c_tpu.cli._add_common_meth_args``);
``--device`` selects the torch device.  The default is ``cuda`` and a run
with no card is an error: ``--device cpu`` is the explicit request for
the kernels' plain PyTorch versions on the host.  The other subcommands
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys

from f5c_tpu.cli import _add_common_meth_args, _out_fh

__version__ = "0.1.0"


def _make_pipeline(args, device):
    """Options as ``f5c_tpu.cli._make_pipeline`` builds them
    (cli.py:144-193), with the port's Pipeline."""
    from .pipeline.runner import Options, Pipeline

    opt = Options(
        min_mapq=args.min_mapq,
        keep_secondary=args.secondary == "yes",
        meth_out_version=args.meth_out_version,
        rna=args.rna,
        pore=args.pore,
        kmer_model_path=args.kmer_model,
        meth_model_path=args.meth_model,
        min_num_events_to_rescale=args.min_recalib_events,
        device=args.device,
        slow5_path=args.slow5,
        verbose=args.verbose,
        events_engine="host",
    )
    if args.profile:
        from f5c_tpu.profiles import apply_profile

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
    opt.ultra_thresh = args.ultra_thresh
    opt.skip_ultra = args.skip_ultra
    return Pipeline(args.bam, args.genome, args.reads, opt, device)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(
        prog="f5c-tpu-torch",
        description="nanopore signal analysis on PyTorch and CUDA "
                    "(call-methylation)")
    ap.add_argument("--version", action="version",
                    version=f"f5c-tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("call-methylation", help="CpG methylation calling",
                       conflict_handler="resolve")
    _add_common_meth_args(p)
    p.add_argument("--meth-out-version", type=int, choices=[1, 2], default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels (an "
                        "error without a card); 'cpu' runs their plain "
                        "PyTorch versions")
    args = ap.parse_args(argv)

    unported = [flag for flag, given in (
        ("--dist", args.dist), ("--profile-dir", args.profile_dir),
        ("--events-engine device", args.events_engine == "device"))
        if given]
    if unported:
        ap.error(f"{', '.join(unported)}: not ported to f5c_tpu_torch yet "
                 "(ROADMAP.md)")
    knobs = [n for n in ("disable_cuda", "cuda_dev_id", "cuda_mem_frac",
                         "cuda_block_size", "cuda_max_lf", "cuda_avg_epk",
                         "cuda_max_epk") if getattr(args, n) is not None]
    if knobs:
        print("f5c-tpu-torch: warning: --"
              + ", --".join(n.replace("_", "-") for n in knobs)
              + ": accepted for f5c compatibility, no effect yet",
              file=sys.stderr)

    from .backend import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"f5c-tpu-torch: error: {e}", file=sys.stderr)
        return 2
    pipe = _make_pipeline(args, device)
    out = _out_fh(args.output)
    try:
        pipe.call_methylation(out=out)
    finally:
        if out is not sys.stdout:
            out.close()
    return pipe.report()


if __name__ == "__main__":
    sys.exit(main())

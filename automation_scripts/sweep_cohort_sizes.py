#!/usr/bin/env python
"""Cohort-size sweep: ours (mt) vs the reference binary (mt), as a TSV.

Repeatable implementation of the reference's published sweep protocol
(reference: automation_scripts/performance_benchmark.py:33-100): one master
cohort VCF, per-size prefix subsets produced by cutting sample COLUMNS
(``cut -f 1-9,10-N`` -- every size sees the same variant records), a
page-cache warmup pass, then a timed end-to-end run per tool per size. The
reference times a single run; this records the BEST of ``--reps`` (default 2,
after one discarded warmup) because host timings on a shared machine are
noisy.

Output TSV columns: tool_name, input_size, runtime_s, samples_per_s --
the reference's Performance_Results.tsv schema plus throughput.

    python automation_scripts/sweep_cohort_sizes.py \
        --out automation_scripts/artifacts/sweep_cohort_sizes.tsv

"""
import argparse
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

REF_BIN = "/root/reference/bins/Linux/vcf2prot"
SEED = 20260817  # the standard driver-bench cohort


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_master(workdir, n_samples, n_transcripts):
    from genvcf import random_cohort, write_fasta, write_synthetic_vcf

    vcf = os.path.join(workdir, f"sweep_master_{n_samples}x{n_transcripts}.vcf")
    fasta = os.path.join(workdir, f"sweep_ref_{n_transcripts}.fasta")
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        log(f"generating master cohort: {n_samples} x {n_transcripts}")
        ref, samples = random_cohort(
            seed=SEED, n_samples=n_samples, n_transcripts=n_transcripts
        )
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)
    return vcf, fasta


def cut_prefix(master_vcf, n, workdir):
    """Per-size input: first 9 fixed columns + the first n sample columns
    (the reference's cut -f 1-9,10-{9+n})."""
    out = os.path.join(workdir, f"sweep_{n}.vcf")
    if not os.path.exists(out):
        with open(out, "w") as fh:
            subprocess.run(
                ["cut", "-f", f"1-9,10-{9 + n}", master_vcf],
                stdout=fh, check=True,
            )
    return out


def warm_cache(path):
    with open(path, "rb") as fh:
        while fh.read(1 << 24):
            pass


def time_ours(vcf, fasta, outdir, reps):
    from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
    from vcf2prot_tpu.runtime.engine import Engine

    times = []
    for rep in range(reps + 1):
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        cfg = PipelineConfig(
            vcf_path=vcf, fasta_path=fasta, outdir=outdir,
            engine=Engine.MT, num_threads=os.cpu_count(), qc=None,
        )
        t0 = time.perf_counter()
        run_pipeline(cfg)
        if rep > 0:
            times.append(time.perf_counter() - t0)
    return min(times)


def time_reference(vcf, fasta, outdir, reps, timeout):
    env = dict(os.environ, NO_TEST="1")
    cmd = [REF_BIN, "-f", vcf, "-r", fasta, "-o", outdir, "-g", "mt"]
    times = []
    for rep in range(reps + 1):
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        t0 = time.perf_counter()
        subprocess.run(cmd, env=env, capture_output=True, check=True,
                       timeout=timeout)
        if rep > 0:
            times.append(time.perf_counter() - t0)
    return min(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,4,8,16,32,64,128",
                    help="comma-separated sample counts (reference protocol)")
    ap.add_argument("--transcripts", type=int, default=1200)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--ref-timeout", type=int, default=600,
                    help="per-run cap for the reference binary; a size that "
                    "exceeds it records 'timeout'")
    ap.add_argument("--out", default=os.path.join(
        REPO, "automation_scripts", "artifacts", "sweep_cohort_sizes.tsv"))
    ap.add_argument("--workdir", default="/tmp/vcf2prot_sweep")
    args = ap.parse_args()

    # synthetic cohorts trip the QC system (deliberate overlaps); the
    # reference's own protocol disables it the same way
    os.environ.setdefault("NO_TEST", "1")
    sizes = [int(s) for s in args.sizes.split(",")]
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    master_vcf, fasta = build_master(args.workdir, max(sizes),
                                     args.transcripts)
    rows = []
    for n in sizes:
        vcf = cut_prefix(master_vcf, n, args.workdir)
        warm_cache(vcf)
        ours = time_ours(
            vcf, fasta, os.path.join(args.workdir, "our_out"), args.reps
        )
        rows.append(("vcf2prot_tpu_mt", n, f"{ours:.3f}", f"{n/ours:.2f}"))
        log(f"n={n}: ours {ours:.3f}s ({n/ours:.1f} samples/s)")
        if os.access(REF_BIN, os.X_OK):
            try:
                ref = time_reference(
                    vcf, fasta, os.path.join(args.workdir, "ref_out"),
                    args.reps, args.ref_timeout,
                )
                rows.append(
                    ("reference_mt", n, f"{ref:.3f}", f"{n/ref:.2f}")
                )
                log(f"n={n}: reference {ref:.3f}s ({n/ref:.1f} samples/s), "
                    f"ratio {ref/ours:.1f}x")
            except subprocess.TimeoutExpired:
                rows.append(("reference_mt", n, "timeout", ""))
                log(f"n={n}: reference timed out (> {args.ref_timeout}s)")
    with open(args.out, "w") as fh:
        fh.write("tool_name\tinput_size\truntime_s\tsamples_per_s\n")
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()

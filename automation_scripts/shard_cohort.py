#!/usr/bin/env python
"""Out-of-process cohort sharding across sample batches.

Counterpart of the reference's process-pool wrapper (reference:
automation_scripts/parallization_python.py:196-207): split a cohort
BCF/VCF into per-batch sample subsets with ``bcftools view -S`` and run one
pipeline process per batch. Within one host the in-process engines already
use every core, so this wrapper is mainly for spreading one cohort across
*machines* (submit one batch per node) or for memory-capping very large
cohorts; the in-process equivalent for several GPUs of one host is
``vcf2prot_tpu.parallel.sharded`` (one mesh, dp-sharded cohort).

With a device engine (``-g gpu`` or ``auto``) every job opens a
card, and a JAX process reserves most of a card's memory, so ``-j`` is capped
at the number of visible cards and each job is pinned to its own card with
``CUDA_VISIBLE_DEVICES``. This wrapper itself never starts JAX.
"""
import argparse
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def get_samples(vcf):
    out = subprocess.run(
        ["bcftools", "query", "-l", vcf], check=True, capture_output=True,
        text=True,
    )
    return [s for s in out.stdout.splitlines() if s]


def visible_gpus():
    """Ids of the GPUs a child process may use, read without starting JAX:
    ``CUDA_VISIBLE_DEVICES`` when set, else ``nvidia-smi -L``."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, check=True,
        ).stdout
    except (OSError, subprocess.CalledProcessError):
        return []
    return [str(i) for i, line in enumerate(
        l for l in out.splitlines() if l.startswith("GPU ")
    )]


def run_lane(lane):
    """Run a list of batches one after another (on one card, if pinned)."""
    return [run_batch(job) for job in lane]


def run_batch(args):
    vcf, fasta, outdir, samples, engine, card = args
    os.makedirs(outdir, exist_ok=True)
    sample_file = os.path.join(outdir, "samples.txt")
    with open(sample_file, "w") as fh:
        fh.write("\n".join(samples) + "\n")
    batch_vcf = os.path.join(outdir, "batch.vcf")
    subprocess.run(
        ["bcftools", "view", vcf, "-S", sample_file, "-O", "v", "-o", batch_vcf],
        check=True,
    )
    cmd = [
        sys.executable, "-m", "vcf2prot_tpu",
        "-f", batch_vcf, "-r", fasta, "-o", outdir, "-g", engine,
    ]
    env = dict(os.environ)
    env.setdefault("NO_TEST", "1")
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = card
    proc = subprocess.run(cmd, env=env)
    return proc.returncode


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--vcf_file", required=True)
    ap.add_argument("-r", "--fasta_ref", required=True)
    ap.add_argument("-o", "--output_dir", required=True)
    ap.add_argument("-b", "--batch_size", type=int, default=64)
    ap.add_argument("-j", "--jobs", type=int, default=os.cpu_count())
    ap.add_argument("-g", "--engine", default="mt")
    args = ap.parse_args(argv)

    samples = get_samples(args.vcf_file)
    batches = [
        samples[i:i + args.batch_size]
        for i in range(0, len(samples), args.batch_size)
    ]
    device = args.engine.lower() in ("gpu", "auto")
    cards = visible_gpus() if device else []
    n_lanes = min(args.jobs, len(cards)) if cards else args.jobs
    n_lanes = max(n_lanes, 1)
    lanes = [
        [
            (
                args.vcf_file,
                args.fasta_ref,
                os.path.join(args.output_dir, f"batch_{i:04d}"),
                batch,
                args.engine,
                cards[lane] if cards else None,
            )
            for i, batch in enumerate(batches) if i % n_lanes == lane
        ]
        for lane in range(n_lanes)
    ]
    failures = 0
    with ProcessPoolExecutor(max_workers=n_lanes) as pool:
        for rcs in pool.map(run_lane, lanes):
            failures += sum(rc != 0 for rc in rcs)
    print(f"{len(batches) - failures}/{len(batches)} batches succeeded")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

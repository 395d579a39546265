"""Measure 2-host scaling efficiency of the sharded native parse+compile.

Multi-host sample sharding pushes the sample subset INTO the native
decode+compile (the in-process analogue of the reference's per-batch
`bcftools view -S` sharding, automation_scripts/parallization_python.py:
196-207). This script measures the efficiency on one machine by running the
two shards SEQUENTIALLY -- each shard then sees the whole machine, as each
host would in a real cluster -- and reports

    efficiency = T_1proc / (2 * max(T_shard0, T_shard1))

Usage: python automation_scripts/measure_multihost_scaling.py
       [n_samples] [n_transcripts]
Not yet measured on the H100 host.
"""
import os
import shutil
import sys
import tempfile
import time

# the bench protocol: QC checks off, like the reference's published runs
# (the synthetic cohort contains conflict groups that QC would abort on)
os.environ.setdefault("NO_TEST", "1")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

from genvcf import random_cohort, write_fasta, write_synthetic_vcf  # noqa: E402
from vcf2prot_tpu.parallel.multihost import host_sample_shard  # noqa: E402
from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline  # noqa: E402
from vcf2prot_tpu.runtime.engine import Engine  # noqa: E402


def timed_run(vcf, fasta, outdir, sample_indices, repeats=3):
    best_wall = float("inf")
    best_stages = None
    for _ in range(repeats):
        if os.path.exists(outdir):
            shutil.rmtree(outdir)
        os.makedirs(outdir)
        t0 = time.perf_counter()
        res = run_pipeline(
            PipelineConfig(
                vcf_path=vcf, fasta_path=fasta, outdir=outdir,
                engine=Engine.MT, sample_indices=sample_indices,
            )
        )
        wall = time.perf_counter() - t0
        if wall < best_wall:
            best_wall = wall
            best_stages = dict(res.durations)
    return best_wall, best_stages


def main():
    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    n_transcripts = int(sys.argv[2]) if len(sys.argv) > 2 else 1200
    tmp = tempfile.mkdtemp(prefix="v2p_scaling_")
    try:
        ref, samples = random_cohort(
            seed=20260817, n_samples=n_samples, n_transcripts=n_transcripts
        )
        vcf = os.path.join(tmp, "c.vcf")
        fasta = os.path.join(tmp, "r.fasta")
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)

        t1, s1 = timed_run(vcf, fasta, os.path.join(tmp, "full"), None)
        shard_walls = []
        shard_stages = []
        for pi in range(2):
            w, s = timed_run(
                vcf, fasta, os.path.join(tmp, f"shard{pi}"),
                host_sample_shard(n_samples, pi, 2),
            )
            shard_walls.append(w)
            shard_stages.append(s)
        t2 = max(shard_walls)
        eff = t1 / (2 * t2)
        key = "Parsing and compiling (native)"
        print(f"cohort: {n_samples} samples x {n_transcripts} transcripts")
        print(f"1-process wall: {t1:.3f}s  (parse+compile {s1[key]:.3f}s)")
        for pi in range(2):
            print(
                f"shard {pi} wall: {shard_walls[pi]:.3f}s  "
                f"(parse+compile {shard_stages[pi][key]:.3f}s)"
            )
        print(f"2-host scaling efficiency: {eff:.1%} (target >= 80%)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()

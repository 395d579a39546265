"""Multi-host sharding logic (simulated: shard assignment + disjoint outputs)."""
import os

from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu.parallel.multihost import host_sample_shard
from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu.runtime.engine import Engine


def test_shards_partition_contiguous_balanced():
    n = 23
    shards = [host_sample_shard(n, pi, 4) for pi in range(4)]
    flat = sorted(i for s in shards for i in s)
    assert flat == list(range(n))
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1
    # contiguity is what lets the native walk skip/stop outside the shard
    for s in shards:
        assert s == list(range(s[0], s[0] + len(s)))


def test_simulated_two_host_run(tmp_path):
    """Two 'hosts' each run their shard; the union equals the full run."""
    ref, samples = random_cohort(seed=13, n_samples=6, n_transcripts=8)
    vcf = tmp_path / "c.vcf"
    fasta = tmp_path / "r.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fasta), ref)

    full = tmp_path / "full"
    full.mkdir()
    run_pipeline(
        PipelineConfig(
            vcf_path=str(vcf), fasta_path=str(fasta), outdir=str(full),
            engine=Engine.ST,
        )
    )

    union = {}
    for pi in range(2):
        shard_out = tmp_path / f"shard{pi}"
        shard_out.mkdir()
        run_pipeline(
            PipelineConfig(
                vcf_path=str(vcf), fasta_path=str(fasta),
                outdir=str(shard_out), engine=Engine.ST,
                sample_indices=host_sample_shard(6, pi, 2),
            )
        )
        for f in os.listdir(shard_out):
            assert f not in union, "sample written by two shards"
            union[f] = (shard_out / f).read_bytes()

    full_files = {f: (full / f).read_bytes() for f in os.listdir(full)}
    assert union == full_files


def test_shard_partitions_native_decode_work(tmp_path):
    """The dominant parse+compile stage must SPLIT across hosts, not be
    duplicated. Asserted on DETERMINISTIC native work counters (owned-
    carrier mask decodes, compiled haplotypes) instead of wall-clock
    ratios: the round-4 0.8x timing assertion raced co-tenant scheduling
    on a ~30 ms stage and flaked under full-suite load. Counters are
    exact: the two half-shards' decode work must
    partition the full run's, and each half must do materially less than
    the whole."""
    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QC_OFF
    from vcf2prot_tpu.native_bridge import compile_cohort_native, load_native

    if load_native() is None:
        import pytest

        pytest.skip("native module unavailable")
    ref, samples = random_cohort(seed=5, n_samples=192, n_transcripts=120)
    vcf = tmp_path / "c.vcf"
    write_synthetic_vcf(str(vcf), ref, samples)
    blob = RefBlob.from_ref_seqs(ref)

    def compile_counters(sample_indices):
        counters = {}
        compile_cohort_native(
            str(vcf), ref, blob, QC_OFF, sample_subset=sample_indices,
            counters=counters,
        )
        return counters

    full = compile_counters(None)
    half0 = compile_counters(host_sample_shard(192, 0, 2))
    half1 = compile_counters(host_sample_shard(192, 1, 2))
    assert full["mask_decodes"] > 0
    assert full["haplotypes"] == 2 * 192
    assert half0["haplotypes"] == half1["haplotypes"] == 192
    # decode work partitions exactly: every owned-carrier mask is decoded
    # by exactly one shard
    assert half0["mask_decodes"] + half1["mask_decodes"] == (
        full["mask_decodes"]
    )
    # and the split is material (carriers are ~uniform across samples)
    assert max(half0["mask_decodes"], half1["mask_decodes"]) <= (
        0.75 * full["mask_decodes"]
    )


def test_initialize_distributed_single_process(tmp_path):
    """jax.distributed single-process init + run_multihost_pipeline smoke
    (run in a subprocess so the distributed runtime doesn't leak into other
    tests)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = f"""
import os, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {repo!r} + "/tests")
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
from genvcf import random_cohort, write_synthetic_vcf, write_fasta
from vcf2prot_tpu.parallel.multihost import (
    initialize_distributed, run_multihost_pipeline,
)
from vcf2prot_tpu.pipeline import PipelineConfig
from vcf2prot_tpu.runtime.engine import Engine
initialize_distributed("localhost:19732", num_processes=1, process_id=0)
ref, samples = random_cohort(seed=3, n_samples=4, n_transcripts=6)
d = {str(tmp_path)!r}
write_synthetic_vcf(d + "/c.vcf", ref, samples)
write_fasta(d + "/r.fasta", ref)
os.makedirs(d + "/out", exist_ok=True)
res = run_multihost_pipeline(PipelineConfig(
    vcf_path=d + "/c.vcf", fasta_path=d + "/r.fasta",
    outdir=d + "/out", engine=Engine.MT,
))
files = sorted(os.listdir(d + "/out/shard_0"))
assert len(files) == 4, files
print("MULTIHOST_OK", res.n_samples)
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert "MULTIHOST_OK 4" in proc.stdout


def test_two_process_distributed_run(tmp_path):
    """Actual 2-process jax.distributed run (single machine): disjoint sample
    shards, union covers the cohort."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = str(tmp_path)
    ref, samples = random_cohort(seed=3, n_samples=6, n_transcripts=6)
    write_synthetic_vcf(d + "/c.vcf", ref, samples)
    write_fasta(d + "/r.fasta", ref)
    os.makedirs(d + "/out")
    script = f"""
import os, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {repo!r} + "/tests")
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
from vcf2prot_tpu.parallel.multihost import initialize_distributed, run_multihost_pipeline
from vcf2prot_tpu.pipeline import PipelineConfig
from vcf2prot_tpu.runtime.engine import Engine
pid = int(sys.argv[1]); d = sys.argv[2]
initialize_distributed("localhost:19742", num_processes=2, process_id=pid)
run_multihost_pipeline(PipelineConfig(
    vcf_path=d+"/c.vcf", fasta_path=d+"/r.fasta", outdir=d+"/out",
    engine=Engine.MT))
"""
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid), d],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    for p in procs:
        _out, err = p.communicate(timeout=160)
        assert p.returncode == 0, err[-1200:]
    shard0 = set(os.listdir(d + "/out/shard_0"))
    shard1 = set(os.listdir(d + "/out/shard_1"))
    assert not (shard0 & shard1)
    assert len(shard0 | shard1) == 6


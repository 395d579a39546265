"""Golden parity against the reference's prebuilt Linux binary.

Runs the actual ikmb/vcf2prot binary (bundled in the reference checkout) and
our pipeline on the same randomized synthetic cohort, asserting record-level
FASTA equality (the reference's record *order* is HashMap-nondeterministic, so
comparison is by header -> sequence mapping; sequences must be byte-equal).
"""
import os
import subprocess

import pytest

from genvcf import read_fasta_records, random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu.runtime.engine import Engine

REF_BIN = "/root/reference/bins/Linux/vcf2prot"

pytestmark = pytest.mark.skipif(
    not os.access(REF_BIN, os.X_OK), reason="reference binary not available"
)




@pytest.mark.parametrize("seed", [42, 7, 99])
def test_record_parity_with_reference_binary(seed, tmp_path):
    ref, samples = random_cohort(seed=seed, n_samples=6, n_transcripts=12)
    vcf = tmp_path / "cohort.vcf"
    fasta = tmp_path / "ref.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fasta), ref)
    ref_out = tmp_path / "ref_out"
    our_out = tmp_path / "our_out"
    ref_out.mkdir()
    our_out.mkdir()

    env = dict(os.environ, NO_TEST="1")
    subprocess.run(
        [REF_BIN, "-f", str(vcf), "-r", str(fasta), "-o", str(ref_out), "-g", "mt"],
        check=True,
        env=env,
        capture_output=True,
    )
    run_pipeline(
        PipelineConfig(
            vcf_path=str(vcf),
            fasta_path=str(fasta),
            outdir=str(our_out),
            engine=Engine.DEVICE,
        )
    )

    ref_files = sorted(os.listdir(ref_out))
    our_files = sorted(os.listdir(our_out))
    assert ref_files == our_files
    for f in ref_files:
        a = read_fasta_records(ref_out / f)
        b = read_fasta_records(our_out / f)
        assert set(a) == set(b), f"{f}: header sets differ"
        for k in a:
            assert a[k] == b[k], f"{f}:{k}: sequence mismatch"


def test_write_all_parity_with_reference_binary(tmp_path):
    """-a mode: altered records plus unaltered reference records per
    haplotype (personalized_genome.rs:120-210)."""
    ref, samples = random_cohort(seed=17, n_samples=3, n_transcripts=8)
    vcf = tmp_path / "cohort.vcf"
    fasta = tmp_path / "ref.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fasta), ref)
    ref_out = tmp_path / "ref_out"
    our_out = tmp_path / "our_out"
    ref_out.mkdir()
    our_out.mkdir()
    subprocess.run(
        [REF_BIN, "-f", str(vcf), "-r", str(fasta), "-o", str(ref_out),
         "-g", "mt", "-a"],
        check=True,
        env=dict(os.environ, NO_TEST="1"),
        capture_output=True,
    )
    run_pipeline(
        PipelineConfig(
            vcf_path=str(vcf),
            fasta_path=str(fasta),
            outdir=str(our_out),
            engine=Engine.MT,
            write_all=True,
        )
    )
    for f in sorted(os.listdir(ref_out)):
        a = read_fasta_records(ref_out / f)
        b = read_fasta_records(our_out / f)
        assert set(a) == set(b), f"{f}: header sets differ"
        for k in a:
            assert a[k] == b[k], f"{f}:{k}: sequence mismatch"


def test_compressed_output_parity(tmp_path):
    """-c gzip mode: compressed bytes differ across zlib settings, but the
    decompressed records must match the reference binary's."""
    import gzip

    ref, samples = random_cohort(seed=23, n_samples=3, n_transcripts=8)
    vcf = tmp_path / "cohort.vcf"
    fasta = tmp_path / "ref.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fasta), ref)
    ref_out = tmp_path / "ref_out"
    our_out = tmp_path / "our_out"
    ref_out.mkdir()
    our_out.mkdir()
    subprocess.run(
        [REF_BIN, "-f", str(vcf), "-r", str(fasta), "-o", str(ref_out),
         "-g", "mt", "-c"],
        check=True, env=dict(os.environ, NO_TEST="1"), capture_output=True,
    )
    run_pipeline(
        PipelineConfig(
            vcf_path=str(vcf), fasta_path=str(fasta), outdir=str(our_out),
            engine=Engine.MT, write_compressed=True,
        )
    )
    files = sorted(os.listdir(ref_out))
    assert files == sorted(os.listdir(our_out))
    assert all(f.endswith(".fasta.gz") for f in files)

    def gz_records(path):
        recs = {}
        header = None
        with gzip.open(path, "rt") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    header = line[1:]
                    recs[header] = ""
                elif header is not None:
                    recs[header] += line
        return recs

    for f in files:
        assert gz_records(ref_out / f) == gz_records(our_out / f), f

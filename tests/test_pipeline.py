"""End-to-end pipeline tests: synthetic VCF + FASTA through the full stack,
asserting host-engine and device-engine runs produce identical FASTA bytes,
plus stats/intmap outputs and frontend decode correctness."""
import gzip
import json
import os

import pytest

from genvcf import read_fasta_records, random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu.frontend import vcf_reader
from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu.runtime.engine import Engine


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    ref, samples = random_cohort(seed=5, n_samples=6, n_transcripts=10)
    vcf_path = str(root / "cohort.vcf")
    fasta_path = str(root / "ref.fasta")
    write_synthetic_vcf(vcf_path, ref, samples)
    write_fasta(fasta_path, ref)
    return ref, samples, vcf_path, fasta_path


def test_frontend_decode_roundtrip(cohort):
    ref, samples, vcf_path, _ = cohort
    vcf = vcf_reader.read_vcf(vcf_path)
    assert vcf.probands == list(samples)
    early = vcf_reader.build_early_maps(vcf)
    for em in early:
        h1_expect, h2_expect = samples[em.proband]
        assert sorted(em.mutations1) == sorted(h1_expect)
        assert sorted(em.mutations2) == sorted(h2_expect)


def run(cohort, tmp_path, engine, **kw):
    ref, samples, vcf_path, fasta_path = cohort
    outdir = tmp_path / f"out_{engine.value}"
    outdir.mkdir(parents=True)
    cfg = PipelineConfig(
        vcf_path=vcf_path,
        fasta_path=fasta_path,
        outdir=str(outdir),
        engine=engine,
        **kw,
    )
    return run_pipeline(cfg), outdir




def test_engines_agree(cohort, tmp_path):
    res_st, out_st = run(cohort, tmp_path, Engine.ST)
    res_dev, out_dev = run(cohort, tmp_path, Engine.DEVICE)
    res_mt, out_mt = run(cohort, tmp_path, Engine.MT)
    assert res_st.n_samples == res_dev.n_samples == 6
    files = sorted(os.listdir(out_st))
    assert files == sorted(os.listdir(out_dev)) == sorted(os.listdir(out_mt))
    assert len(files) == 6
    for f in files:
        a = (out_st / f).read_bytes()
        b = (out_dev / f).read_bytes()
        c = (out_mt / f).read_bytes()
        assert a == b == c


def test_output_sequences_are_sane(cohort, tmp_path):
    ref, samples, _, _ = cohort
    _res, outdir = run(cohort, tmp_path / "sane", Engine.ST)
    for f in os.listdir(outdir):
        recs = read_fasta_records(outdir / f)
        assert recs, f"no records in {f}"
        for header, seq in recs.items():
            name, hap = header.rsplit("_", 1)
            assert hap in ("1", "2")
            assert name in ref
            # personalized sequences must differ from reference in length or
            # content only in plausible ways; at minimum be non-empty unless
            # erased by start_lost
            assert len(seq) == 0 or set(seq) <= set("ACDEFGHIKLMNPQRSTVWY.")


def test_write_all_and_compressed(cohort, tmp_path):
    ref, samples, _, _ = cohort
    _res, outdir = run(
        cohort, tmp_path / "all", Engine.ST, write_all=True, write_compressed=True
    )
    files = os.listdir(outdir)
    assert all(f.endswith(".fasta.gz") for f in files)
    recs = read_fasta_records(outdir / files[0])
    # every transcript appears on both haplotypes (altered or reference form)
    for name in ref:
        assert f"{name}_1" in recs
        assert f"{name}_2" in recs


def test_stats_and_intmap_outputs(cohort, tmp_path):
    ref, samples, _, _ = cohort
    _res, outdir = run(
        cohort, tmp_path / "stats", Engine.ST, compute_stats=True, write_int_map=True
    )
    assert (outdir / "number_of_mutations_per_proband.tsv").exists()
    assert (outdir / "type_of_mutations_per_patient.tsv").exists()
    assert (outdir / "number_of_mutations_per_transcript.tsv").exists()
    int_dir = outdir / "int_maps"
    files = os.listdir(int_dir)
    assert len(files) == 6
    doc = json.loads((int_dir / files[0]).read_text())
    assert {"proband_name", "mutations1", "mutations2"} <= set(doc)


def test_cli_end_to_end(cohort, tmp_path):
    from vcf2prot_tpu.cli import main

    ref, samples, vcf_path, fasta_path = cohort
    outdir = tmp_path / "cli_out"
    outdir.mkdir()
    rc = main(
        [
            "-f", vcf_path,
            "-r", fasta_path,
            "-o", str(outdir),
            "-g", "st",
            "-v", "-s",
        ]
    )
    assert rc == 0
    assert any(f.endswith(".fasta") for f in os.listdir(outdir))


def test_execute_programs_library_api(cohort):
    """execute_programs is the library-level batch API (arrays, not files)."""
    import numpy as np

    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QcConfig
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.pipeline import execute_programs
    from vcf2prot_tpu.frontend.fasta import read_fasta

    ref, samples, vcf_path, fasta_path = cohort
    ref_seqs = read_fasta(fasta_path)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _p, programs, _w = compile_cohort_native(
        vcf_path, ref_seqs, blob, QcConfig()
    )
    st = execute_programs(programs, blob, Engine.ST)
    dev = execute_programs(programs, blob, Engine.DEVICE, validate_host=True)
    for a, b in zip(st, dev):
        np.testing.assert_array_equal(a, b)


def test_profile_flag_writes_trace(cohort, tmp_path):
    ref, samples, vcf_path, fasta_path = cohort
    outdir = tmp_path / "prof_out"
    outdir.mkdir()
    trace_dir = tmp_path / "trace"
    cfg = PipelineConfig(
        vcf_path=vcf_path,
        fasta_path=fasta_path,
        outdir=str(outdir),
        engine=Engine.DEVICE,
        profile_dir=str(trace_dir),
    )
    run_pipeline(cfg)
    assert trace_dir.is_dir()
    assert any(trace_dir.rglob("*"))


def test_debug_gpu_passes_on_good_cohort(cohort, tmp_path):
    """DEBUG_GPU: the device engine validates every chunk's task stream on
    the device (CPU backend here) and a well-formed cohort runs through to
    the same bytes as the host oracle."""
    from vcf2prot_tpu.compiler.qc import QcConfig

    _res, out_st = run(cohort, tmp_path, Engine.ST)
    _res, out_dev = run(
        cohort, tmp_path, Engine.DEVICE,
        qc=QcConfig(debug_device_exec=True),
    )
    files = sorted(os.listdir(out_st))
    assert files == sorted(os.listdir(out_dev))
    for f in files:
        assert (out_st / f).read_bytes() == (out_dev / f).read_bytes()


def test_debug_gpu_raises_on_corrupted_cohort(cohort, tmp_path, monkeypatch):
    """DEBUG_GPU: one corrupted task ``dst`` in the compiled cohort makes the
    run raise instead of quietly isolating the program to the host oracle."""
    from vcf2prot_tpu import native_bridge
    from vcf2prot_tpu.compiler.qc import QcConfig

    real = native_bridge.compile_cohort_native

    def corrupted(*args, **kwargs):
        probands, flat, *rest = real(*args, **kwargs)
        prog = next(p for p in flat if p.n_tasks > 1)
        prog.dst = prog.dst.copy()
        prog.dst[1] += 3
        return (probands, flat, *rest)

    monkeypatch.setattr(native_bridge, "compile_cohort_native", corrupted)
    with pytest.raises(AssertionError, match="validation failed"):
        run(cohort, tmp_path, Engine.DEVICE,
            qc=QcConfig(debug_cpu_exec=False, debug_device_exec=True))

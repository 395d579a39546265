"""Edge-case and flag coverage: compressed inputs, error paths, engine
aliases, writer modes, early-map dumps."""
import gzip
import os

import pytest

from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu.frontend import fasta, vcf_reader
from vcf2prot_tpu.frontend.maps import (
    AltTranscript,
    ConflictingMutationsError,
    group_muts_per_transcript,
)
from vcf2prot_tpu.io.writers import write_earlymap2json
from vcf2prot_tpu.frontend.maps import EarlyMap
from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu.runtime.engine import Engine


def test_gzipped_inputs(tmp_path):
    ref, samples = random_cohort(seed=21, n_samples=3, n_transcripts=6)
    vcf_plain = tmp_path / "c.vcf"
    fasta_plain = tmp_path / "r.fasta"
    write_synthetic_vcf(str(vcf_plain), ref, samples)
    write_fasta(str(fasta_plain), ref)
    vcf_gz = tmp_path / "c.vcf.gz"
    fasta_gz = tmp_path / "r.fasta.gz"
    with open(vcf_plain, "rb") as fin, gzip.open(vcf_gz, "wb") as fout:
        fout.write(fin.read())
    with open(fasta_plain, "rb") as fin, gzip.open(fasta_gz, "wb") as fout:
        fout.write(fin.read())

    out_plain = tmp_path / "p"
    out_gz = tmp_path / "g"
    out_plain.mkdir()
    out_gz.mkdir()
    # native path must handle gz inputs too (transparent decompression)
    run_pipeline(PipelineConfig(str(vcf_plain), str(fasta_plain), str(out_plain), Engine.ST, use_native=False))
    run_pipeline(PipelineConfig(str(vcf_gz), str(fasta_gz), str(out_gz), Engine.ST, use_native=True))
    for f in os.listdir(out_plain):
        assert (out_plain / f).read_bytes() == (out_gz / f).read_bytes()


def test_engine_aliases():
    assert Engine.from_str("gpu") is Engine.DEVICE
    assert Engine.from_str("GPU") is Engine.DEVICE
    assert Engine.from_str("auto") is Engine.AUTO
    for gone in ("cuda", "device"):
        with pytest.raises(ValueError):
            Engine.from_str(gone)


def test_missing_header_is_error(tmp_path):
    p = tmp_path / "x.vcf"
    p.write_text("1\t1\tv\tA\tT\t9\tPASS\tBCSQ=x\tGT\t0|1:3\n")
    with pytest.raises(vcf_reader.VcfFormatError):
        vcf_reader.read_vcf(str(p))


def test_no_supported_records_is_error(tmp_path):
    p = tmp_path / "x.vcf"
    p.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
        "1\t1\tv\tA\tT\t9\tPASS\tAF=0.1\tGT\t0|1:3\n"
    )
    with pytest.raises(vcf_reader.VcfFormatError):
        vcf_reader.read_vcf(str(p))


def test_no_samples_is_error(tmp_path):
    p = tmp_path / "x.vcf"
    p.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\n"
        "1\t1\tv\tA\tT\t9\tPASS\tBCSQ=x\tGT\n"
    )
    with pytest.raises(vcf_reader.VcfFormatError):
        vcf_reader.read_vcf(str(p))


def test_empty_fasta_is_error(tmp_path):
    p = tmp_path / "e.fasta"
    p.write_text("")
    with pytest.raises(fasta.FastaFormatError):
        fasta.read_fasta(str(p))


def test_conflicting_mutations_abort():
    # two different mutations at the same reference position
    csqs = [
        "missense|G|ENST00000000001|protein_coding|+|10A>10B|1A>1T",
        "missense|G|ENST00000000001|protein_coding|+|10A>10C|1A>1T",
    ]
    with pytest.raises(ConflictingMutationsError):
        group_muts_per_transcript(csqs)


def test_identical_duplicates_are_deduped():
    csqs = [
        "missense|G|ENST00000000001|protein_coding|+|10A>10B|1A>1T",
        "missense|G|ENST00000000001|protein_coding|+|10A>10B|1A>1T",
    ]
    groups = group_muts_per_transcript(csqs)
    assert len(groups) == 1
    assert len(groups[0].alts) == 1


def test_single_thread_writes_flag(tmp_path):
    ref, samples = random_cohort(seed=8, n_samples=3, n_transcripts=5)
    vcf = tmp_path / "c.vcf"
    fa = tmp_path / "r.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fa), ref)
    out = tmp_path / "o"
    out.mkdir()
    run_pipeline(
        PipelineConfig(
            str(vcf), str(fa), str(out), Engine.ST, single_thread_writes=True
        )
    )
    assert len([f for f in os.listdir(out) if f.endswith(".fasta")]) == 3


def test_write_earlymap2json(tmp_path):
    maps = [EarlyMap("S1", ["a|b"], ["c|d"]), EarlyMap("S2", [], [])]
    out = tmp_path / "early"
    write_earlymap2json(str(out), maps)
    assert sorted(os.listdir(out)) == ["S1.json", "S2.json"]
    with pytest.raises(FileExistsError):
        write_earlymap2json(str(out), maps)


def test_native_and_python_agree_on_substring_grouping(tmp_path):
    """Transcript ids of different lengths trigger the substring-capture
    grouping path in both tiers."""
    ref = {
        "ENST001": "M" + "A" * 60,
        "ENST0011": "M" + "C" * 60,
    }
    muts_long = "missense|G|ENST0011|protein_coding|+|10C>10D|1A>1T"
    muts_short = "missense|G|ENST001|protein_coding|+|5A>5K|1A>1T"
    vcf = tmp_path / "s.vcf"
    vcf.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
        f"1\t1\tv1\tA\tT\t9\tPASS\tBCSQ={muts_short},{muts_long}\tGT:BCSQ\t0|1:5\n"
    )
    fa = tmp_path / "s.fasta"
    write_fasta(str(fa), ref)
    outs = {}
    for native in (True, False):
        out = tmp_path / f"o{native}"
        out.mkdir()
        run_pipeline(
            PipelineConfig(str(vcf), str(fa), str(out), Engine.ST, use_native=native)
        )
        outs[native] = {
            f: (out / f).read_bytes() for f in os.listdir(out)
        }
    assert outs[True] == outs[False]


def test_short_form_start_lost_through_record_flow(tmp_path):
    """Short-form start_lost (4 fields, no AA change) fails the 6-pipe record
    filter alone, but rides along when another supported entry shares the
    record; it then synthesizes '1M>1*' and erases its transcript
    (text_parser.rs:43-49). All tiers must agree."""
    ref = {
        "ENST00000000001": "M" + "A" * 50,
        "ENST00000000002": "M" + "C" * 50,
    }
    entries = ",".join(
        [
            "missense|G|ENST00000000001|protein_coding|+|5A>5K|1A>1T",
            "start_lost|G|ENST00000000002|protein_coding",
        ]
    )
    vcf = tmp_path / "s.vcf"
    vcf.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
        f"1\t1\tv1\tA\tT\t9\tPASS\tBCSQ={entries}\tGT:BCSQ\t0|1:5\n"
    )
    fa = tmp_path / "s.fasta"
    write_fasta(str(fa), ref)
    outs = {}
    for native in (True, False):
        out = tmp_path / f"sl{native}"
        out.mkdir()
        run_pipeline(
            PipelineConfig(str(vcf), str(fa), str(out), Engine.ST, use_native=native)
        )
        outs[native] = (out / "S1.fasta").read_text()
    assert outs[True] == outs[False]
    # the erased transcript appears as an empty record on hap1
    assert ">ENST00000000002_1\n\n" in outs[True]
    assert ">ENST00000000001_1\n" in outs[True]
    # reference binary agrees
    import os as _os
    import subprocess as _sp

    ref_bin = "/root/reference/bins/Linux/vcf2prot"
    if _os.access(ref_bin, _os.X_OK):
        rb_out = tmp_path / "rb"
        rb_out.mkdir()
        _sp.run(
            [ref_bin, "-f", str(vcf), "-r", str(fa), "-o", str(rb_out), "-g", "st"],
            check=True, env=dict(_os.environ, NO_TEST="1"), capture_output=True,
        )
        def recs(text):
            d = {}
            h = None
            for line in text.splitlines():
                if line.startswith(">"):
                    h = line[1:]
                    d[h] = ""
                elif h is not None:
                    d[h] += line
            return d
        assert recs((rb_out / "S1.fasta").read_text()) == recs(outs[True])


def test_info_keys_after_bcsq_parity(tmp_path):
    """INFO keys AFTER BCSQ= ride into the payload in the reference
    (split('BCSQ=')[1] takes the rest of INFO); all tiers must mirror it."""
    import subprocess

    ref = {"ENST00000000001": "M" + "A" * 50}
    entries = "missense|G|ENST00000000001|protein_coding|+|5A>5K|1A>1T"
    vcf = tmp_path / "s.vcf"
    vcf.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
        f"1\t1\tv1\tA\tT\t9\tPASS\tBCSQ={entries};AF=0.25\tGT:BCSQ\t0|1:1\n"
    )
    fa = tmp_path / "s.fasta"
    write_fasta(str(fa), ref)
    outs = {}
    for native in (True, False):
        out = tmp_path / f"ib{native}"
        out.mkdir()
        run_pipeline(
            PipelineConfig(str(vcf), str(fa), str(out), Engine.ST, use_native=native)
        )
        outs[native] = (out / "S1.fasta").read_bytes()
    assert outs[True] == outs[False]
    ref_bin = "/root/reference/bins/Linux/vcf2prot"
    if os.access(ref_bin, os.X_OK):
        rb = tmp_path / "rb"
        rb.mkdir()
        subprocess.run(
            [ref_bin, "-f", str(vcf), "-r", str(fa), "-o", str(rb), "-g", "st"],
            check=True, env=dict(os.environ, NO_TEST="1"), capture_output=True,
        )
        assert (rb / "S1.fasta").read_bytes() == outs[True]


def test_version_mismatch_skips_transcript(tmp_path):
    """Mutation positions beyond the reference protein (annotation/proteome
    version mismatch) skip the transcript in both tiers instead of reading
    neighbouring blob bytes or crashing."""
    ref = {"ENST00000000001": "M" + "A" * 20, "ENST00000000002": "M" + "C" * 50}
    entries = ",".join(
        [
            # position 40 in a 21-residue protein: out of range
            "missense|G|ENST00000000001|protein_coding|+|40A>40K|1A>1T",
            "missense|G|ENST00000000002|protein_coding|+|10C>10K|1A>1T",
        ]
    )
    vcf = tmp_path / "m.vcf"
    vcf.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
        f"1\t1\tv1\tA\tT\t9\tPASS\tBCSQ={entries}\tGT:BCSQ\t0|1:5\n"
    )
    fa = tmp_path / "m.fasta"
    write_fasta(str(fa), ref)
    for native in (True, False):
        out = tmp_path / f"vm{native}"
        out.mkdir()
        run_pipeline(
            PipelineConfig(str(vcf), str(fa), str(out), Engine.ST, use_native=native)
        )
        text = (out / "S1.fasta").read_text()
        assert "ENST00000000002_1" in text      # in-range transcript kept
        assert "ENST00000000001" not in text    # out-of-range one skipped

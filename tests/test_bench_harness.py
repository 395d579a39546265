"""The bench harness's neoantigen legs run in the bench's own process (one
process per card); pin their contract on a tiny cohort (CPU backend)."""
import importlib.util
import os

import pytest

from genvcf import random_cohort, write_fasta, write_synthetic_vcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_cohort(tmp_path_factory):
    d = tmp_path_factory.mktemp("benchneo")
    ref, samples = random_cohort(seed=42, n_samples=2, n_transcripts=6)
    vcf = str(d / "c.vcf")
    fasta = str(d / "r.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fasta, ref)
    return d, vcf, fasta


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_neo_snippet_contract(tiny_cohort, monkeypatch):
    d, vcf, fasta = tiny_cohort
    monkeypatch.setenv("NO_TEST", "1")  # synthetic cohorts trip the QC
    bench = _load_bench()
    payload = bench.neo_legs(vcf, fasta, str(d / "out"))
    # the harness contract: both legs with cold/dt seconds
    assert set(payload) == {"device", "mt"}, payload
    for leg in payload.values():
        assert leg["cold"] > 0 and leg["dt"] > 0
    # both legs produced per-sample TSVs with the same ranked rows
    rows = {}
    for mode in ("device", "mt"):
        outdir = d / f"out_{mode}"
        tsvs = sorted(f for f in os.listdir(outdir) if f.endswith(".tsv"))
        assert len(tsvs) == 2, (mode, tsvs)
        rows[mode] = [
            [line.split("\t")[:4]
             for line in (outdir / f).read_text().splitlines()]
            for f in tsvs
        ]
    assert rows["device"] == rows["mt"]

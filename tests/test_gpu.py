"""Card-only checks: the device engine and the DEBUG_GPU validator compiled
for an NVIDIA GPU. They skip on the CPU; on a GPU host run
``VCF2PROT_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``
(``python chip_smoke.py`` covers the same paths at full size)."""
import os

import pytest

from genvcf import random_cohort, write_fasta, write_synthetic_vcf

pytestmark = pytest.mark.gpu


@pytest.fixture
def cohort_files(tmp_path):
    ref, samples = random_cohort(seed=12, n_samples=4, n_transcripts=10)
    vcf, fasta = str(tmp_path / "c.vcf"), str(tmp_path / "r.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fasta, ref)
    return vcf, fasta


def test_gpu_fasta_matches_mt(gpu_device, cohort_files, tmp_path,
                              monkeypatch):
    from vcf2prot_tpu.cli import main

    monkeypatch.setenv("NO_TEST", "1")
    vcf, fasta = cohort_files
    outs = {}
    for engine in ("gpu", "mt"):
        out = tmp_path / engine
        out.mkdir()
        assert main(["-f", vcf, "-r", fasta, "-o", str(out),
                     "-g", engine]) == 0
        outs[engine] = {f: (out / f).read_bytes() for f in os.listdir(out)}
    assert outs["gpu"] == outs["mt"]


def test_gpu_validator_catches_corruption(gpu_device):
    import numpy as np

    from vcf2prot_tpu.runtime.kernels import validate_on_device

    dst = np.arange(0, 40, 4, dtype=np.int32)
    length = np.full(10, 4, np.int32)
    srcb = np.zeros(10, np.int32)
    assert validate_on_device(dst, length, srcb, 100, 40, gpu_device) == 0
    dst[5] += 1
    assert validate_on_device(dst, length, srcb, 100, 40, gpu_device) > 0

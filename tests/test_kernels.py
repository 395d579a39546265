"""Device-side task-program validator (the DEBUG_GPU check; one jitted jnp
reduction, run here on the CPU backend)."""
import numpy as np

from genvcf import random_cohort
from vcf2prot_tpu.compiler.haplotype import RefBlob, compile_haplotype
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.frontend.maps import group_muts_per_transcript
from vcf2prot_tpu.runtime.kernels import validate_on_device
from vcf2prot_tpu.runtime.pack import pack_cohort


def packed_cohort(seed=2):
    ref, samples = random_cohort(seed, 4, 8)
    blob = RefBlob.from_ref_seqs(ref)
    programs = []
    for _n, (h1, h2) in samples.items():
        for csqs in (h1, h2):
            programs.append(
                compile_haplotype(
                    group_muts_per_transcript(csqs), ref, blob, qc=QcConfig()
                )
            )
    return blob, pack_cohort(programs, blob)


def test_valid_program_passes():
    blob, packed = packed_cohort()
    errors = validate_on_device(
        packed.dst, packed.length, packed.src_biased,
        combined_len=len(blob.data) + len(packed.alt),
        res_len=packed.total_res,
    )
    assert errors == 0


def test_corrupted_dst_detected():
    blob, packed = packed_cohort()
    dst = packed.dst.copy()
    dst[len(dst) // 2] += 3  # break contiguity
    errors = validate_on_device(
        dst, packed.length, packed.src_biased,
        combined_len=len(blob.data) + len(packed.alt),
        res_len=packed.total_res,
    )
    assert errors > 0


def test_out_of_bounds_source_detected():
    blob, packed = packed_cohort()
    srcb = packed.src_biased.copy()
    srcb[0] = len(blob.data) + len(packed.alt) + 100
    errors = validate_on_device(
        packed.dst, packed.length, srcb,
        combined_len=len(blob.data) + len(packed.alt),
        res_len=packed.total_res,
    )
    assert errors > 0


def test_engine_raises_on_corrupted_program():
    """DEBUG_GPU on the single-device engine: one corrupted task ``dst``
    raises before the engine would isolate the program to the host oracle;
    without validation the same chunk still runs (isolated)."""
    import pytest

    from vcf2prot_tpu.runtime.device_engine import DeviceEngine

    ref, samples = random_cohort(3, 3, 6)
    blob = RefBlob.from_ref_seqs(ref)
    programs = [
        compile_haplotype(group_muts_per_transcript(csqs), ref, blob,
                          qc=QcConfig())
        for h1, h2 in samples.values() for csqs in (h1, h2)
    ]
    assert len(DeviceEngine(blob, validate_on_device=True).execute(
        programs)) == len(programs)
    victim = next(p for p in programs if p.n_tasks > 1)
    victim.dst = victim.dst.copy()
    victim.dst[1] += 3
    with pytest.raises(AssertionError, match="validation failed"):
        DeviceEngine(blob, validate_on_device=True).execute(programs)
    assert len(DeviceEngine(blob).execute(programs)) == len(programs)

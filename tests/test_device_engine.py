"""Device-engine parity: the XLA gather executor must agree byte-for-byte with
the serial host oracle on randomized cohorts (run on the CPU backend here; the
same code path runs on the GPU)."""
import numpy as np
import pytest

from genvcf import random_cohort
from vcf2prot_tpu.compiler.haplotype import RefBlob, compile_haplotype
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.frontend.maps import group_muts_per_transcript
from vcf2prot_tpu.runtime.cpu_engine import execute_tasks
from vcf2prot_tpu.runtime.device_engine import DeviceEngine

QC = QcConfig()


def build_programs(seed, n_samples=6, n_transcripts=10):
    ref, samples = random_cohort(seed, n_samples, n_transcripts)
    blob = RefBlob.from_ref_seqs(ref)
    programs = []
    for _name, (h1, h2) in samples.items():
        for csqs in (h1, h2):
            alt_transcripts = group_muts_per_transcript(csqs)
            programs.append(compile_haplotype(alt_transcripts, ref, blob, qc=QC))
    return ref, blob, programs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_matches_oracle(seed):
    ref, blob, programs = build_programs(seed)
    engine = DeviceEngine(blob)
    device_out = engine.execute(programs)
    assert len(device_out) == len(programs)
    for prog, dev in zip(programs, device_out):
        oracle = execute_tasks(prog, blob)
        np.testing.assert_array_equal(oracle, dev)


def test_empty_programs():
    ref, blob, programs = build_programs(7, n_samples=1)
    engine = DeviceEngine(blob)
    from vcf2prot_tpu.compiler.haplotype import HaplotypeProgram

    outs = engine.execute([HaplotypeProgram()])
    assert len(outs) == 1 and outs[0].size == 0


def test_bucket_reuse_across_chunks():
    ref, blob, programs = build_programs(11)
    engine = DeviceEngine(blob)
    engine.execute(programs[:3])
    n_compiled = len(engine._run_cache)
    engine.execute(programs[:3])
    assert len(engine._run_cache) == n_compiled


def test_aligned_executor_matches_delta_and_oracle(monkeypatch):
    """The word-aligned production kernel and the per-byte delta fallback
    must both equal the host oracle byte-for-byte (ARCHITECTURE 2.3:
    aligned32 is the default, delta stays as fallback)."""
    ref, blob, programs = build_programs(5, n_samples=8, n_transcripts=12)
    total = sum(p.res_len for p in programs)
    assert total >= 1024  # the aligned path engages above this floor
    aligned = DeviceEngine(blob).execute(programs)
    monkeypatch.setenv("VCF2PROT_ALIGNED_EXEC", "0")
    delta = DeviceEngine(blob).execute(programs)
    for prog, a, d in zip(programs, aligned, delta):
        oracle = execute_tasks(prog, blob)
        np.testing.assert_array_equal(oracle, a)
        np.testing.assert_array_equal(oracle, d)


def test_build_aligned_program_partition():
    """Middle words + boundary bytes must partition the output exactly:
    every byte is either in a word-uniform middle of exactly one task or on
    the boundary list, and all indices replay to the oracle output."""
    from vcf2prot_tpu.runtime.pack import pack_cohort
    from vcf2prot_tpu.runtime.device_engine import build_aligned_program

    ref, blob, programs = build_programs(3, n_samples=4)
    packed = pack_cohort(programs, blob)
    alt_arr = (
        np.frombuffer(packed.alt, np.uint8)
        if isinstance(packed.alt, (bytes, bytearray))
        else np.asarray(packed.alt, np.uint8)
    )
    combined = np.concatenate([blob.data, alt_arr, np.zeros(16, np.uint8)])
    wstart, wbase, bpos, bsrc = build_aligned_program(
        packed.dst, packed.src_biased, packed.total_res, len(combined)
    )
    total = packed.total_res
    out = np.zeros(total, np.uint8)
    # replay middles: word w's base = wbase[last task with wstart <= w]
    n_words = (total + 3) >> 2
    covered = np.zeros(total, bool)
    order = np.argsort(wstart, kind="stable")
    base_per_word = np.full(n_words, np.iinfo(np.int64).min, np.int64)
    for t in order:
        if wstart[t] < n_words:
            base_per_word[wstart[t]] = wbase[t]
    cur = 0
    bset = set(bpos.tolist())
    for w in range(n_words):
        if base_per_word[w] != np.iinfo(np.int64).min:
            cur = base_per_word[w]
        for b in range(4 * w, min(4 * w + 4, total)):
            if b in bset:
                continue
            out[b] = combined[cur + b]
            covered[b] = True
    for p, s in zip(bpos, bsrc):
        out[p] = combined[s]
        covered[p] = True
    assert covered.all()
    oracle = np.concatenate(
        [execute_tasks(p, blob) for p in programs]
    )
    np.testing.assert_array_equal(out, oracle[:total])

#!/usr/bin/env python
"""Chunk-pipelining gain of the device-resident neoantigen chain.

The report writer double-buffers: chunk N+1's dense+rank dispatch overlaps
chunk N's packed-row fetch + TSV writes (device_resident.py). This probe
measures that overlap on the GPU: a multi-chunk cohort driven (a)
synchronously -- collect(dispatch(chunk)) one at a time -- and (b)
pipelined in the writer's dispatch-ahead order. Both decode the same rows;
the delta is hidden fetch/host time (the reference analogue keeps all
workers busy end-to-end, exec.rs:36-39).

    python -u automation_scripts/measure_chunk_pipeline.py
Env: PIPE_SAMPLES (256), PIPE_TRANSCRIPTS (1200), PIPE_CHUNK_MB (24),
     PIPE_REPS (3)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

N_SAMPLES = int(os.environ.get("PIPE_SAMPLES", "256"))
N_TXP = int(os.environ.get("PIPE_TRANSCRIPTS", "1200"))
CHUNK_MB = int(os.environ.get("PIPE_CHUNK_MB", "24"))
REPS = int(os.environ.get("PIPE_REPS", "3"))
K = 9


def main():
    os.environ.setdefault("NO_TEST", "1")

    from genvcf import random_cohort, write_fasta, write_synthetic_vcf
    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QC_OFF
    from vcf2prot_tpu.downstream import device_resident as dr
    from vcf2prot_tpu.frontend import fasta as fasta_mod
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.pipeline import _chunk_indices

    workdir = "/tmp/vcf2prot_pipe"
    os.makedirs(workdir, exist_ok=True)
    vcf = os.path.join(workdir, f"c_{N_SAMPLES}x{N_TXP}.vcf")
    fasta = os.path.join(workdir, f"r_{N_TXP}.fasta")
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        ref, samples = random_cohort(
            seed=20260821, n_samples=N_SAMPLES, n_transcripts=N_TXP
        )
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)
    ref_seqs = fasta_mod.read_fasta(fasta)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _, programs, _ = compile_cohort_native(vcf, ref_seqs, blob, QC_OFF,
                                           alt_pool="auto")
    chunk_bytes = CHUNK_MB << 20
    chunks = _chunk_indices(programs, chunk_bytes, pair_aligned=True)
    buckets = dr.run_buckets(programs, chunks)
    print(f"{N_SAMPLES}x{N_TXP}: {len(chunks)} chunks, out bucket "
          f"{buckets.out} ({buckets.out >> 20} Mi lanes)", flush=True)
    if len(chunks) < 2:
        sys.exit("need >= 2 chunks; lower PIPE_CHUNK_MB")
    eng = dr.DeviceNeoantigenEngine(blob, K, top=200)

    def sequential():
        rows = 0
        for chunk in chunks:
            progs = [programs[i] for i in chunk]
            out = eng.collect(eng.dispatch(progs, buckets=buckets))
            rows += sum(len(r) for r in out.values())
        return rows

    def pipelined():
        rows = 0
        pending = None
        for chunk in chunks:
            progs = [programs[i] for i in chunk]
            handle = eng.dispatch(progs, buckets=buckets)
            if pending is not None:
                out = eng.collect(pending)
                rows += sum(len(r) for r in out.values())
            pending = handle
        out = eng.collect(pending)
        rows += sum(len(r) for r in out.values())
        return rows

    # warm both (compiles / cache loads)
    t0 = time.perf_counter()
    n_rows = sequential()
    print(f"cold warmup: {time.perf_counter() - t0:.1f}s "
          f"({n_rows} rows)", flush=True)

    def best(fn):
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            r = fn()
            ts.append(time.perf_counter() - t0)
            assert r == n_rows
        return min(ts)

    t_seq = best(sequential)
    t_pipe = best(pipelined)
    print(f"sequential (collect per dispatch): {t_seq:.3f}s", flush=True)
    print(f"pipelined (dispatch-ahead):        {t_pipe:.3f}s "
          f"({t_seq / t_pipe:.2f}x)", flush=True)


if __name__ == "__main__":
    main()

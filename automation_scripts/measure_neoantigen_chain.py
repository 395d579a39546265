#!/usr/bin/env python
"""Measure the dense device-resident neoantigen chain on the GPU.

Records the cost of the full execute -> mask -> bf16 score -> rank chain
(downstream/device_resident.py); each run_chunk ends in the device-to-host
fetch of its [S, top] rows, which is the sync. The accelerator role the
reference stubs (reference: src/data_structures/InternalRep/gir.rs:283-299,
README.md:72).

Reports, per run: cold wall (compile + run; served by the persistent
compile cache when warm) and warm best-of-N wall for run_chunk, plus a
host-path comparison on the same chunk.

Usage:  python automation_scripts/measure_neoantigen_chain.py
Env:    NEO_SAMPLES (64), NEO_TRANSCRIPTS (600), NEO_REPS (3), NEO_HOST=0
        to skip the host-path comparison.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(
    0,
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"
    ),
)

N_SAMPLES = int(os.environ.get("NEO_SAMPLES", "64"))
N_TXP = int(os.environ.get("NEO_TRANSCRIPTS", "600"))
REPS = int(os.environ.get("NEO_REPS", "3"))
K = 9


def main():
    from genvcf import random_cohort, write_fasta, write_synthetic_vcf
    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QC_OFF
    from vcf2prot_tpu.downstream.device_resident import (
        DeviceNeoantigenEngine,
        _host_chunk_rows,
    )
    from vcf2prot_tpu.downstream.scoring import init_params
    from vcf2prot_tpu.frontend import fasta as fasta_mod
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.runtime.pack import pack_cohort

    workdir = "/tmp/vcf2prot_neochain"
    os.makedirs(workdir, exist_ok=True)
    vcf = os.path.join(workdir, f"c_{N_SAMPLES}x{N_TXP}.vcf")
    fasta = os.path.join(workdir, f"r_{N_TXP}.fasta")
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        ref, samples = random_cohort(
            seed=20260820, n_samples=N_SAMPLES, n_transcripts=N_TXP
        )
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)

    ref_seqs = fasta_mod.read_fasta(fasta)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _, programs, _ = compile_cohort_native(vcf, ref_seqs, blob, QC_OFF)
    packed = pack_cohort(programs, blob)
    print(
        f"cohort {N_SAMPLES}x{N_TXP}: {len(packed.dst)} tasks, "
        f"{packed.total_res / 1e6:.1f} MB result tape, k={K}",
        flush=True,
    )

    import jax

    dev = jax.devices()[0]
    print(f"backend: {dev.platform} {getattr(dev, 'device_kind', '?')}",
          flush=True)

    params = init_params(K)
    eng = DeviceNeoantigenEngine(blob, K, params=params, top=200)

    # cold: compile + one run; run_chunk's [S, top] fetch is the sync
    t0 = time.perf_counter()
    rows = eng.run_chunk(programs)
    cold = time.perf_counter() - t0
    assert rows is not None, "chunk fell back to host (malformed pack?)"
    n_rows = sum(len(r) for r in rows.values())
    print(f"cold (compile+run): {cold:.3f}s, {n_rows} result rows",
          flush=True)

    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        rows_w = eng.run_chunk(programs)
        times.append(time.perf_counter() - t0)
    warm = min(times)
    print(
        f"warm run_chunk: {warm:.3f}s best of {REPS} "
        f"({N_SAMPLES / warm:.1f} samples/s device-resident; "
        f"{packed.total_res / warm / 1e6:.0f} MB tape scored/s)",
        flush=True,
    )

    if os.environ.get("NEO_HOST", "1") == "1":
        t0 = time.perf_counter()
        host_rows = _host_chunk_rows(programs, blob, K, params, 200)
        host = time.perf_counter() - t0
        print(
            f"host chain (oracle exec + host collect + batched score): "
            f"{host:.3f}s ({N_SAMPLES / host:.1f} samples/s)",
            flush=True,
        )
        print(f"device/host ratio: {host / warm:.2f}x", flush=True)
        # On-device bf16 scoring rounds differently across the two batch
        # shapes (dense lax.map blocks vs one bucketed batch), so rows can
        # swap ORDER or trade the boundary row at the top-`top` cutoff while
        # agreeing on scores to ~1e-3; report that structure instead of a
        # bare exact-match bool (exact equality is asserted by the CPU test
        # suite where both paths score bit-identically).
        exact = order_only = boundary = 0
        deltas = [0.0]
        for i in rows_w:
            ds = [r[1:] for r in rows_w[i]]
            hs = [r[1:] for r in host_rows[i]]
            if ds == hs:
                exact += 1
            elif set(ds) == set(hs):
                order_only += 1
            else:
                boundary += 1
            dd = {k: r[0] for k, r in zip(ds, rows_w[i])}
            hh = {k: r[0] for k, r in zip(hs, host_rows[i])}
            deltas.extend(abs(dd[k] - hh[k]) for k in set(dd) & set(hh))
        print(
            f"row agreement: {exact} exact, {order_only} order-only, "
            f"{boundary} top-{200} boundary swaps; max |score delta| on "
            f"common rows {max(deltas):.2e}",
            flush=True,
        )


if __name__ == "__main__":
    main()

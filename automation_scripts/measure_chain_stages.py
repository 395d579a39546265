#!/usr/bin/env python
"""Stage-split of the device-resident neoantigen chain on the GPU.

Times, each ending in ``block_until_ready``: the dense pass (execute +
masks + gather-free one-hot scoring), the rank pass (stable sort +
per-sample selection), and the full run_chunk including the [S, top]
fetch. This split is what exposed the one-hot LUT gather as the chain's
dominant cost on the accelerator this was first tuned on (fixed by
peptides.encode_windows).

Every stage time also prints its %-of-peak denominator (utils/roofline,
keyed by the device's device_kind): MFU against the bf16 peak for the
dense scoring pass, HBM-bandwidth fraction for the executor-shaped and
sort-shaped stages.

Usage:  python automation_scripts/measure_chain_stages.py
Env:    NEO_SAMPLES (64), NEO_TRANSCRIPTS (600), NEO_REPS (3),
        NEO_EMBED (32), NEO_HIDDEN (128), NEO_DEPTH (1) -- head size
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
EMBED = int(os.environ.get("NEO_EMBED", "32"))
HIDDEN = int(os.environ.get("NEO_HIDDEN", "128"))
DEPTH = int(os.environ.get("NEO_DEPTH", "1"))
K = 9


def main():
    import numpy as np

    import jax
    from genvcf import random_cohort, write_fasta, write_synthetic_vcf
    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QC_OFF
    from vcf2prot_tpu.downstream import device_resident as dr
    from vcf2prot_tpu.downstream.scoring import init_params
    from vcf2prot_tpu.frontend import fasta as fasta_mod
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.runtime.pack import pack_cohort, pad_to_bucket

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
    params = init_params(K, embed_dim=EMBED, hidden=HIDDEN, depth=DEPTH)
    eng = dr.DeviceNeoantigenEngine(blob, K, params=params, top=200)
    packed = pack_cohort(programs, blob)
    ann_s_raw, ann_e_raw = dr._chunk_annotation_spans(programs, packed.spans)
    n_samples = len(programs) // 2
    out_bucket = pad_to_bucket(packed.total_res)
    task_bucket = pad_to_bucket(len(packed.dst))
    imax = np.iinfo(np.int32).max
    dst = np.full(task_bucket, imax, np.int32)
    dst[: len(packed.dst)] = packed.dst
    srcb = np.zeros(task_bucket, np.int32)
    srcb[: len(packed.src_biased)] = packed.src_biased
    exe = np.zeros(task_bucket, np.int8)
    exe[: len(packed.src_biased)] = packed.src_biased >= len(blob.data)
    ann_bucket = pad_to_bucket(max(len(ann_s_raw), 1))
    ann_s = np.full(ann_bucket, imax, np.int32)
    ann_s[: len(ann_s_raw)] = ann_s_raw
    ann_e = np.zeros(ann_bucket, np.int32)
    ann_e[: len(ann_e_raw)] = ann_e_raw
    s_bucket = pad_to_bucket(n_samples)
    st = np.full(s_bucket, imax, np.int32)
    st[:n_samples] = [packed.spans[2 * i][1] for i in range(n_samples)]
    combined = eng._combined(packed)
    put = lambda a: jax.device_put(a, eng.device)  # noqa: E731
    blk = dr.dense_blk(out_bucket, params)
    n_tiles = out_bucket // blk
    tl, m_task = dr.tile_slices(packed.dst, blk, n_tiles, K - 1)
    al, m_ann = dr.tile_slices(ann_s_raw, blk, n_tiles, 0)
    m_task = min(task_bucket, pad_to_bucket(m_task))
    m_ann = min(ann_bucket, pad_to_bucket(m_ann))
    spb = dr.count_spb(st[:n_samples], dr.rank_blk(out_bucket))
    dense = dr._dense_fn(out_bucket, K, blk, m_task, m_ann)
    rank = dr._rank_fn(out_bucket, K, s_bucket, 200, spb)
    args_d = (combined, put(dst), put(srcb), put(exe), put(ann_s),
              put(ann_e), params, np.int32(packed.total_res),
              put(tl), put(al))

    sync1 = jax.block_until_ready
    kind = jax.devices()[0].device_kind

    print(f"cohort {N_SAMPLES}x{N_TXP}: out_bucket {out_bucket} "
          f"({packed.total_res / 1e6:.1f} MB live)", flush=True)
    t0 = time.perf_counter()
    tape, cand, scores = dense(*args_d)
    rows = rank(tape, cand, scores, put(st))  # packed [S, top, 8+k] buffer
    sync1(rows)
    print(f"cold (compile or cache-load + run): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    def best(f):
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            f()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_dense = best(lambda: sync1(dense(*args_d)[2]))
    t_rank = best(lambda: sync1(rank(tape, cand, scores, put(st))))
    t_full = best(lambda: eng.run_chunk(programs))

    from vcf2prot_tpu.utils.roofline import (
        dense_pass_flops,
        executor_bytes,
        hbm_fraction,
        mfu,
        peaks,
        scoring_flops_per_window,
    )

    print(f"head: E={EMBED} H={HIDDEN} depth={DEPTH} "
          f"({scoring_flops_per_window(params) / 1e3:.1f} kFLOP/window, "
          f"block {blk})", flush=True)
    # the dense pass = executor (HBM-shaped) + scoring (matmul-shaped); its
    # MFU denominator uses all out_bucket windows because the kernel
    # really scores the padding too
    flops = dense_pass_flops(out_bucket, params)
    print(f"dense (execute+mask+score): {t_dense * 1e3:.0f} ms "
          f"-> {flops / 1e12:.2f} TFLOP = "
          f"{mfu(flops, t_dense, kind) * 100:.1f}% of bf16 peak "
          f"({peaks(kind).bf16_flops / 1e12:.0f} TF/s, {kind})",
          flush=True)
    # rank: one 3-operand stable sort over out_bucket lanes; minimal
    # traffic = log2 rounds x read+write of (key, key, value) i32 lanes
    import math

    sort_bytes = out_bucket * 12 * 2 * math.log2(max(out_bucket, 2))
    print(f"rank (sort+select): {t_rank * 1e3:.0f} ms "
          f"-> >= {sort_bytes / 1e9:.1f} GB sort traffic = "
          f"{hbm_fraction(sort_bytes, t_rank, kind) * 100:.1f}% of HBM "
          f"peak ({peaks(kind).hbm_bps / 1e9:.0f} GB/s)", flush=True)
    ex_bytes = executor_bytes(out_bucket)
    print(f"  (executor-shaped share of dense: {ex_bytes / 1e9:.2f} GB "
          f"per-byte executor traffic)", flush=True)
    print(f"full run_chunk incl [S,top] fetches: {t_full * 1e3:.0f} ms "
          f"({N_SAMPLES / t_full:.0f} samples/s; whole-chain MFU "
          f"{mfu(flops, t_full, kind) * 100:.1f}%)", flush=True)

    # compacted chain (wide heads): the fused mask+compact+score+rank
    # dispatch, compared against the dense+rank sum on the same chunk
    c_bucket = min(out_bucket, pad_to_bucket(max(
        dr.cand_bound(programs, K), 1)))
    if (os.environ.get("NEO_COMPACT", "1") == "1"
            and c_bucket * 4 <= out_bucket and K <= 13):
        compact = dr._compact_fn(
            out_bucket, K, blk, m_task, m_ann, c_bucket, s_bucket, 200
        )
        args_c = (combined, put(dst), put(srcb), put(exe), put(ann_s),
                  put(ann_e), put(st), params, np.int32(packed.total_res),
                  put(tl), put(al))
        t0 = time.perf_counter()
        sync1(compact(*args_c))
        print(f"compact chain cold: {time.perf_counter() - t0:.1f}s",
              flush=True)
        t_comp = best(lambda: sync1(compact(*args_c)))
        c_flops = dense_pass_flops(c_bucket, params)
        print(
            f"compact chain (mask+sort+gather+score+rank, one dispatch) "
            f": {t_comp * 1e3:.0f} ms -> vs dense+rank "
            f"{(t_dense + t_rank) * 1e3:.0f} ms "
            f"({(t_dense + t_rank) / t_comp:.2f}x); candidate "
            f"bucket {c_bucket} = {c_bucket / out_bucket:.1%} of lanes, "
            f"scored-FLOP MFU {mfu(c_flops, t_comp, kind) * 100:.1f}%",
            flush=True,
        )


if __name__ == "__main__":
    main()

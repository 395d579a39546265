#!/usr/bin/env python
"""Scaling sweep of the resident-chain kernels: 2^25 -> 2^28 lanes.

The monolithic dense+rank body once scaled worse than linear from 2^25 to
2^28 lanes (HBM working-set pressure) and was worked around with 128 MB
chunks. Round 5 replaced the monolithic dense
pass with a tiled lax.map (nothing of size [out, k] or full-length int32
materialized) and the global rank sort with a segmented per-block top-k;
this sweep measures per-lane cost of each kernel at 2^25, 2^26, 2^27 and
2^28 lanes, production (tiled + segmented) vs the round-4 bodies (legacy
dense inlined below; global rank = spb=0), all warm best-of-N, each timing
ending in ``block_until_ready``.

Writes automation_scripts/artifacts/dense_scaling_sweep.tsv.

Usage:  python -u automation_scripts/sweep_dense_scaling.py
Env:    SWEEP_SIZES ("128,256,512,1024" samples at 1200 transcripts),
        SWEEP_MODES ("tiled,legacy,seg,global"), SWEEP_REPS (3)
"""
import os
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

SIZES = [int(s) for s in os.environ.get(
    "SWEEP_SIZES", "128,256,512,1024").split(",")]
MODES = os.environ.get("SWEEP_MODES", "tiled,legacy,seg,global").split(",")
REPS = int(os.environ.get("SWEEP_REPS", "3"))
N_TXP = 1200
K = 9
TOP = 200
ART = os.path.join(_ROOT, "automation_scripts", "artifacts",
                   "dense_scaling_sweep.tsv")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _legacy_dense_fn(out_bucket: int, k: int, blk: int):
    """The round-4 monolithic dense body (pre-tiling), for the A/B:
    full-length expansions, [out, k] window stack, lax.map over
    pre-materialized blocks."""
    import jax
    import jax.numpy as jnp

    from vcf2prot_tpu.downstream.device_resident import NEG, _expand_delta
    from vcf2prot_tpu.downstream.scoring import score_windows
    from vcf2prot_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    def _shift_left(arr, n, fill):
        n = min(n, arr.shape[0])
        return jnp.concatenate([arr[n:], jnp.full(n, fill, arr.dtype)])

    @jax.jit
    def run(combined, dst, srcb, exe, ann_starts, ann_ends, params,
            total_res):
        j = jnp.arange(out_bucket, dtype=jnp.int32)
        base = _expand_delta(jnp, srcb - dst, dst, out_bucket)
        g = jnp.clip(base + j, 0, combined.shape[0] - 1)
        tape = jnp.take(combined, g)
        is_alt = _expand_delta(jnp, exe, dst, out_bucket)
        alt = (is_alt > 0) & (tape != ord(".")) & (j < total_res)
        cum = jnp.cumsum(alt.astype(jnp.int32))
        in_win = _shift_left(cum, k - 1, cum[-1]) - jnp.concatenate(
            [jnp.zeros(1, jnp.int32), cum[:-1]]
        )
        span_end = _expand_delta(jnp, ann_ends, ann_starts, out_bucket)
        cand = (j + k <= span_end) & (j + k <= total_res) & (in_win > 0)
        win = jnp.stack(
            [_shift_left(tape, i, 0) for i in range(k)], axis=1
        )
        scores = jax.lax.map(
            lambda w: score_windows(w, params),
            win.reshape(out_bucket // blk, blk, k),
        ).reshape(out_bucket)
        return tape, cand, jnp.where(cand, scores, NEG)

    return run


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

    params = init_params(K)
    rows = []
    workdir = os.path.join(tempfile.gettempdir(), "vcf2prot_neochain")
    os.makedirs(workdir, exist_ok=True)

    sync1 = jax.block_until_ready

    def best(f):
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            f()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    for n_samples in SIZES:
        vcf = os.path.join(workdir, f"c_{n_samples}x{N_TXP}.vcf")
        fasta = os.path.join(workdir, f"r_{N_TXP}_{n_samples}.vcf.fa")
        if not (os.path.exists(vcf) and os.path.exists(fasta)):
            t0 = time.perf_counter()
            ref, samples = random_cohort(
                seed=20260820, n_samples=n_samples, n_transcripts=N_TXP
            )
            write_synthetic_vcf(vcf, ref, samples)
            write_fasta(fasta, ref)
            log(f"generated {n_samples}x{N_TXP} in "
                f"{time.perf_counter() - t0:.0f}s")
        ref_seqs = fasta_mod.read_fasta(fasta)
        blob = RefBlob.from_ref_seqs(ref_seqs)
        _, programs, _ = compile_cohort_native(vcf, ref_seqs, blob, QC_OFF)
        eng = dr.DeviceNeoantigenEngine(blob, K, params=params, top=TOP)
        packed = pack_cohort(programs, blob)
        ann_s_raw, ann_e_raw = dr._chunk_annotation_spans(
            programs, packed.spans
        )
        n_sp = len(programs) // 2
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
        s_bucket = pad_to_bucket(n_sp)
        starts = np.asarray(
            [packed.spans[2 * i][1] for i in range(n_sp)], np.int32
        )
        st = np.full(s_bucket, imax, np.int32)
        st[:n_sp] = starts
        spb = dr.count_spb(starts, dr.rank_blk(out_bucket))
        combined = eng._combined(packed)
        put = lambda a: jax.device_put(a, eng.device)  # noqa: E731
        blk = dr.dense_blk(out_bucket, params)
        n_tiles = out_bucket // blk
        tl, m_task = dr.tile_slices(packed.dst, blk, n_tiles, K - 1)
        al, m_ann = dr.tile_slices(ann_s_raw, blk, n_tiles, 0)
        m_task = min(task_bucket, pad_to_bucket(m_task))
        m_ann = min(ann_bucket, pad_to_bucket(m_ann))
        args_d = (combined, put(dst), put(srcb), put(exe), put(ann_s),
                  put(ann_e), params, np.int32(packed.total_res),
                  put(tl), put(al))
        args_leg = args_d[:8]
        log(f"--- {n_samples}x{N_TXP}: out_bucket 2^"
            f"{out_bucket.bit_length() - 1} ({packed.total_res / 1e6:.1f} MB"
            f" live), {len(packed.dst)} tasks, blk {blk}, spb {spb}, "
            f"m_task {m_task}, m_ann {m_ann}")

        dense_fns = {}
        if "tiled" in MODES:
            dense_fns["dense_tiled"] = (
                dr._dense_fn(out_bucket, K, blk, m_task, m_ann), args_d
            )
        if "aligned" in MODES and dr.use_aligned_dense(
            out_bucket, int(combined.shape[0])
        ):
            ws, wb, bp, bs, wlo, blo, mw, mb = dr.aligned_dense_inputs(
                packed.dst, packed.src_biased, packed.total_res,
                int(combined.shape[0]), blk, n_tiles, K,
            )
            m_w = min(task_bucket, pad_to_bucket(mw))
            b_bucket = pad_to_bucket(max(len(bp), 1))
            m_b = min(b_bucket, pad_to_bucket(mb))
            ws_p = np.full(task_bucket, imax, np.int32)
            ws_p[: len(ws)] = ws
            wb_p = np.zeros(task_bucket, np.int32)
            wb_p[: len(wb)] = wb
            bp_p = np.full(b_bucket, imax, np.int32)
            bp_p[: len(bp)] = bp
            bs_p = np.zeros(b_bucket, np.int32)
            bs_p[: len(bs)] = bs
            dense_fns["dense_aligned"] = (
                dr._dense_fn_aligned(out_bucket, K, blk, m_task, m_ann,
                                     m_w, m_b),
                args_d + (put(ws_p), put(wb_p), put(bp_p), put(bs_p),
                          put(wlo), put(blo)),
            )
            log(f"aligned: {len(bp)} boundary bytes "
                f"({len(bp) / max(packed.total_res, 1):.1%}), m_w {m_w}, "
                f"m_b {m_b}")
        if "legacy" in MODES:
            dense_fns["dense_legacy"] = (
                _legacy_dense_fn(out_bucket, K, blk), args_leg
            )
        tape = cand = scores = None
        for name, (fn, fargs) in dense_fns.items():
            t0 = time.perf_counter()
            out = fn(*fargs)
            sync1(out[2])
            coldt = time.perf_counter() - t0
            dt = best(lambda: sync1(fn(*fargs)[2]))
            if tape is None:
                tape, cand, scores = out
            rows.append((name, out_bucket, dt, coldt))
            log(f"{name}: {dt * 1e3:.0f} ms warm ({dt / out_bucket * 1e9:.2f}"
                f" ns/lane; cold {coldt:.1f}s)")
        if tape is None:  # rank-only sweep still needs dense outputs
            fn = dr._dense_fn(out_bucket, K, blk, m_task, m_ann)
            tape, cand, scores = fn(*args_d)
        rank_fns = {}
        if "seg" in MODES and dr.use_segmented_rank(
            out_bucket, TOP, dr.rank_blk(out_bucket), spb
        ):
            rank_fns["rank_seg"] = dr._rank_fn(
                out_bucket, K, s_bucket, TOP, spb
            )
        if "global" in MODES:
            rank_fns["rank_global"] = dr._rank_fn(
                out_bucket, K, s_bucket, TOP, 0
            )
        for name, fn in rank_fns.items():
            t0 = time.perf_counter()
            sync1(fn(tape, cand, scores, put(st)))
            coldt = time.perf_counter() - t0
            dt = best(lambda: sync1(fn(tape, cand, scores, put(st))))
            rows.append((name, out_bucket, dt, coldt))
            log(f"{name}: {dt * 1e3:.0f} ms warm ({dt / out_bucket * 1e9:.2f}"
                f" ns/lane; cold {coldt:.1f}s)")

    # per-mode deviation from linear, anchored at the smallest measured size
    anchors = {}
    for name, lanes, dt, _cold in rows:
        if name not in anchors or lanes < anchors[name][0]:
            anchors[name] = (lanes, dt)
    os.makedirs(os.path.dirname(ART), exist_ok=True)
    with open(ART, "w") as fh:
        fh.write("mode\tlanes\twarm_ms\tns_per_lane\tlin_dev\tcold_s\n")
        for name, lanes, dt, coldt in rows:
            a_lanes, a_dt = anchors[name]
            dev = (dt / lanes) / (a_dt / a_lanes)
            fh.write(f"{name}\t{lanes}\t{dt * 1e3:.1f}\t"
                     f"{dt / lanes * 1e9:.3f}\t{dev:.2f}\t{coldt:.1f}\n")
            log(f"{name} @2^{lanes.bit_length() - 1}: {dt * 1e3:.0f} ms, "
                f"lin_dev {dev:.2f}x")
    log(f"wrote {ART}")


if __name__ == "__main__":
    main()

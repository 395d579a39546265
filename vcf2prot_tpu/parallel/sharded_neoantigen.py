"""Multi-chip device-resident neoantigen chain: dp-sharded samples.

Extends the single-device dense chain (downstream/device_resident.py) across
a ``dp`` mesh the same way the FASTA executor scales (parallel/sharded.py):

* samples (haplotype PAIRS) partition across devices, balanced by result
  bytes -- samples are independent, so the chain is embarrassingly parallel
  and no collective appears anywhere in it;
* the reference-proteome blob (and a run-wide shared alt pool, when the
  cohort compiled pooled) is **replicated**; per-shard task/annotation/alt
  tensors are **sharded** on ``dp``;
* one ``shard_map``-jitted program runs execute -> masks -> bf16 matmul scoring
  -> stable-sort ranking on every chip, and only ``[D, samples, top]`` score
  rows plus peptide bytes leave the devices.

Every shard runs at the same padded bucket shapes (max over shards and, via
the caller's :class:`~vcf2prot_tpu.downstream.device_resident.Buckets`, over
chunks), so the whole multi-chunk multi-chip run compiles each function
once. The per-shard compute body is the SAME ``_dense_core``/``_rank_core``
the single-device path jits -- tests pin both against the host oracle chain.

Reference contrast: the reference's only scale-out is a process pool of
binary invocations (automation_scripts/parallization_python.py:196-207) and
its accelerator slot is stubbed (gir.rs:283-299); this module is that slot,
scaled over a mesh.
"""
from __future__ import annotations

import numpy as np

from ..compiler.haplotype import RefBlob
from ..downstream.device_resident import (
    Buckets,
    ChunkHandle,
    _chunk_annotation_spans,
    _dense_core,
    _pack_rows,
    _rank_core,
    dense_blk,
)
from ..downstream.scoring import init_params
from ..runtime.pack import pack_cohort, pad_to_bucket, program_is_contiguous

_FN_CACHE = {}


def partition_pairs(programs, n_shards: int):
    """Partition (hap1, hap2) pairs across shards, balanced by result bytes;
    returns per-shard lists of PAIR indices (greedy longest-first)."""
    n_pairs = len(programs) // 2
    sizes = [
        programs[2 * i].res_len + programs[2 * i + 1].res_len
        for i in range(n_pairs)
    ]
    order = sorted(range(n_pairs), key=lambda i: -sizes[i])
    shards = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for i in order:
        s = loads.index(min(loads))
        shards[s].append(i)
        loads[s] += sizes[i]
    # keep original sample order inside each shard (stable row decode)
    return [sorted(s) for s in shards]


def shard_buckets(programs, chunks, n_shards: int, k: int = 9,
                  params=None, blob=None) -> Buckets:
    """Fold per-(chunk, shard) shape needs into one run-wide Buckets."""
    from ..downstream.device_resident import (
        _chunk_concat_starts,
        _chunk_sample_starts,
        cand_bound,
        count_spb,
        dense_blk,
        rank_blk,
        tile_slices,
    )

    out = tasks = ann = samples = alt = spb = cand = 1
    m_task = m_ann = 1
    pooled = bool(programs) and all(p.pooled for p in programs)
    if pooled:
        alt = len(programs[0].alt)
    shard_progs_all = []
    for chunk in chunks:
        progs = [programs[i] for i in chunk]
        for pair_idxs in partition_pairs(progs, n_shards):
            sp = [
                q for i in pair_idxs
                for q in (progs[2 * i], progs[2 * i + 1])
            ]
            out = max(out, sum(p.res_len for p in sp))
            tasks = max(tasks, sum(p.n_tasks for p in sp))
            ann = max(ann, sum(len(p.annotations) for p in sp))
            samples = max(samples, len(pair_idxs))
            cand = max(cand, cand_bound(sp, k))
            if not pooled:
                alt = max(alt, sum(len(p.alt) for p in sp))
            shard_progs_all.append(sp)
    out_b = pad_to_bucket(out)
    blk = rank_blk(out_b)
    for sp in shard_progs_all:
        spb = max(spb, count_spb(_chunk_sample_starts(sp), blk))
    bpos = m_w = m_b = 1
    if params is not None:
        dblk = dense_blk(out_b, params)
        n_tiles = out_b // dblk
        for sp in shard_progs_all:
            dst_c, ann_c = _chunk_concat_starts(sp)
            m_task = max(m_task, tile_slices(dst_c, dblk, n_tiles, k - 1)[1])
            m_ann = max(m_ann, tile_slices(ann_c, dblk, n_tiles, 0)[1])
        if blob is not None:
            from ..downstream.device_resident import (
                aligned_dense_inputs,
                use_aligned_dense,
            )

            combined_len = len(blob.data) + (
                pad_to_bucket(max(alt, 1)) if not pooled
                else pad_to_bucket(max(len(programs[0].alt), 1))
            )
            if use_aligned_dense(out_b, combined_len):
                for sp in shard_progs_all:
                    packed = pack_cohort(sp, blob)
                    if (not packed.contiguous
                            or packed.dst.dtype != np.int32):
                        continue
                    _w1, _w2, bp, _b2, _l1, _l2, mw, mb = (
                        aligned_dense_inputs(
                            packed.dst, packed.src_biased,
                            packed.total_res, combined_len, dblk,
                            n_tiles, k,
                        )
                    )
                    bpos = max(bpos, len(bp))
                    m_w = max(m_w, mw)
                    m_b = max(m_b, mb)
    return Buckets(
        *(pad_to_bucket(v) for v in (out, tasks, ann, samples, alt)),
        spb=spb,
        cand=pad_to_bucket(cand),
        m_task=pad_to_bucket(m_task),
        m_ann=pad_to_bucket(m_ann),
        bpos=pad_to_bucket(bpos),
        m_w=pad_to_bucket(m_w),
        m_b=pad_to_bucket(m_b),
    )


def _sharded_chain(mesh, buckets: Buckets, k: int, blk: int, top: int,
                   shared_alt: bool, m_task: int, m_ann: int,
                   c_bucket: int, compact: bool, aligned: bool,
                   m_w: int, m_b: int):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..downstream.device_resident import _compact_core
    from ..utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    key = (tuple(d.id for d in mesh.devices.flat), buckets, k, blk, top,
           shared_alt, m_task, m_ann, c_bucket, compact, aligned, m_w, m_b)
    if key in _FN_CACHE:
        return _FN_CACHE[key]

    def per_shard(blob, alt, dst, srcb, exe, ann_s, ann_e, starts,
                  total_res, tile_lo, ann_lo, ws, wb, bp, bs, wlo, blo,
                  params):
        import jax.numpy as jnp

        combined = jnp.concatenate([blob, alt if shared_alt else alt[0]])
        al_args = (
            (ws[0], wb[0], bp[0], bs[0], wlo[0], blo[0]) if aligned
            else None
        )
        if compact:
            vals, gpos, wins = _compact_core(
                combined, dst[0], srcb[0], exe[0], ann_s[0], ann_e[0],
                starts[0], params, total_res[0], tile_lo[0], ann_lo[0],
                out_bucket=buckets.out, k=k, blk=blk, m_task=m_task,
                m_ann=m_ann, c_bucket=c_bucket, s_bucket=buckets.samples,
                top=top,
            )
        else:
            tape, cand, scores = _dense_core(
                combined, dst[0], srcb[0], exe[0], ann_s[0], ann_e[0],
                params, total_res[0], tile_lo[0], ann_lo[0], al_args,
                out_bucket=buckets.out, k=k, blk=blk, m_task=m_task,
                m_ann=m_ann, m_w=m_w, m_b=m_b,
            )
            vals, gpos, wins = _rank_core(
                tape, cand, scores, starts[0],
                out_bucket=buckets.out, k=k, s_bucket=buckets.samples,
                top=top, spb=buckets.spb,
            )
        # one packed [1, S, top, 8+k] buffer per shard: the whole mesh's
        # results come back in ONE [D, ...] fetch (see _pack_rows)
        return _pack_rows(jnp, vals, gpos, wins)[None]

    fn = shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            P(),                                  # blob: replicated
            P() if shared_alt else P("dp", None),  # alt pool / per-shard alt
            P("dp", None), P("dp", None), P("dp", None),   # dst, srcb, exe
            P("dp", None), P("dp", None),          # ann starts / ends
            P("dp", None), P("dp"),                # sample starts, total_res
            P("dp", None), P("dp", None),          # tile_lo, ann_lo
            P("dp", None), P("dp", None),          # wstart, wbase
            P("dp", None), P("dp", None),          # bpos, bsrc
            P("dp", None), P("dp", None),          # wtile_lo, btile_lo
            P(),                                   # params: replicated
        ),
        out_specs=P("dp", None, None, None),
    )
    jitted = jax.jit(fn)
    _FN_CACHE[key] = jitted
    return jitted


class ShardedNeoantigenEngine:
    """dp-mesh twin of DeviceNeoantigenEngine; same ``run_chunk`` contract
    (None => caller falls back to the host chain)."""

    def __init__(self, blob: RefBlob, mesh, k: int, params=None,
                 top: int = 200):
        self.blob = blob
        self.mesh = mesh
        self.k = k
        self.top = top
        self.params = params if params is not None else init_params(k)

    def run_chunk(self, programs, buckets: Buckets = None):
        return self.collect(self.dispatch(programs, buckets=buckets))

    def dispatch(self, programs, buckets: Buckets = None) -> ChunkHandle:
        """Async launch of one chunk over the mesh; pair with
        :meth:`collect` (same contract as the single-device engine)."""
        import jax.numpy as jnp

        n_pairs = len(programs) // 2
        n_shards = self.mesh.devices.size
        host = ChunkHandle("host", n_pairs, None, None, None)
        if not all(program_is_contiguous(p) for p in programs):
            return host
        pair_shards = partition_pairs(programs, n_shards)
        shard_progs = [
            [q for i in idxs for q in (programs[2 * i], programs[2 * i + 1])]
            for idxs in pair_shards
        ]
        packed = [pack_cohort(sp, self.blob) for sp in shard_progs]
        if not all(p.contiguous for p in packed):
            return host
        if any(p.dst.dtype != np.int32 for p in packed):
            return host  # >2 GiB shard: chunk smaller or fall back
        ann = [
            _chunk_annotation_spans(sp, p.spans)
            for sp, p in zip(shard_progs, packed)
        ]
        if any(a is None for a in ann):
            return host
        # grow provided buckets to this chunk's true needs (an undersized
        # axis would silently truncate the shard arrays); callers sizing
        # buckets with shard_buckets() keep the one-compile property
        local = shard_buckets(
            programs, [list(range(len(programs)))], n_shards,
            k=self.k, params=self.params, blob=self.blob,
        )
        buckets = (
            local if buckets is None
            else Buckets(*(max(a, b) for a, b in zip(buckets, local)))
        )
        if self.k > buckets.out:
            return ChunkHandle("empty", n_pairs, None, None, None)
        shared_alt = (
            bool(packed) and packed[0].alt_key is not None
            and all(p.alt_key == packed[0].alt_key for p in packed)
        )
        D = n_shards
        imax = np.iinfo(np.int32).max
        dst = np.full((D, buckets.tasks), imax, np.int32)
        srcb = np.zeros((D, buckets.tasks), np.int32)
        exe = np.zeros((D, buckets.tasks), np.int8)
        ann_s = np.full((D, buckets.ann), imax, np.int32)
        ann_e = np.zeros((D, buckets.ann), np.int32)
        starts = np.full((D, buckets.samples), imax, np.int32)
        total_res = np.zeros(D, np.int32)
        if shared_alt:
            alt = np.zeros(pad_to_bucket(max(len(packed[0].alt), 1)),
                           np.uint8)
            alt[: len(packed[0].alt)] = packed[0].alt
        else:
            alt = np.zeros((D, buckets.alt), np.uint8)
        blob_len = len(self.blob.data)
        for d, p in enumerate(packed):
            n = len(p.dst)
            dst[d, :n] = p.dst
            srcb[d, :n] = p.src_biased
            exe[d, :n] = p.src_biased >= blob_len
            a_s, a_e = ann[d]
            ann_s[d, : len(a_s)] = a_s
            ann_e[d, : len(a_e)] = a_e
            n_sp = len(shard_progs[d]) // 2
            starts[d, :n_sp] = [p.spans[2 * i][1] for i in range(n_sp)]
            total_res[d] = p.total_res
            if not shared_alt:
                alt[d, : len(p.alt)] = p.alt
        from ..downstream.device_resident import (
            aligned_dense_inputs,
            tile_slices,
            use_aligned_dense,
            use_compact,
        )

        blk = dense_blk(buckets.out, self.params)
        n_tiles = buckets.out // blk
        tl = np.zeros((D, n_tiles), np.int32)
        alo = np.zeros((D, n_tiles), np.int32)
        m_task, m_ann = buckets.m_task, buckets.m_ann
        for d, p in enumerate(packed):
            lo, m = tile_slices(p.dst, blk, n_tiles, self.k - 1)
            tl[d], m_task = lo, max(m_task, pad_to_bucket(m))
            lo2, m2 = tile_slices(ann[d][0], blk, n_tiles, 0)
            alo[d], m_ann = lo2, max(m_ann, pad_to_bucket(m2))
        m_task = min(m_task, buckets.tasks)
        m_ann = min(m_ann, buckets.ann)
        c_bucket = min(buckets.cand, buckets.out)
        compact = use_compact(self.params, self.k, buckets.out, c_bucket)
        combined_len = blob_len + (
            alt.shape[0] if shared_alt else alt.shape[1]
        )
        aligned = (not compact) and use_aligned_dense(
            buckets.out, combined_len
        )
        if aligned:
            m_w, m_b = buckets.m_w, buckets.m_b
            b_bucket = buckets.bpos
            progs_a = []
            for p in packed:
                ai = aligned_dense_inputs(
                    p.dst, p.src_biased, p.total_res, combined_len, blk,
                    n_tiles, self.k,
                )
                progs_a.append(ai)
                m_w = max(m_w, pad_to_bucket(ai[6]))
                m_b = max(m_b, pad_to_bucket(ai[7]))
                b_bucket = max(b_bucket, pad_to_bucket(max(len(ai[2]), 1)))
            m_w = min(m_w, buckets.tasks)
            m_b = min(m_b, b_bucket)
            imax32 = np.iinfo(np.int32).max
            ws = np.full((D, buckets.tasks), imax32, np.int32)
            wb = np.zeros((D, buckets.tasks), np.int32)
            bp = np.full((D, b_bucket), imax32, np.int32)
            bs = np.zeros((D, b_bucket), np.int32)
            wlo = np.zeros((D, n_tiles), np.int32)
            blo = np.zeros((D, n_tiles), np.int32)
            for d, (aws, awb, abp, abs_, awlo, ablo, _m1, _m2) in enumerate(
                progs_a
            ):
                ws[d, : len(aws)] = aws
                wb[d, : len(awb)] = awb
                bp[d, : len(abp)] = abp
                bs[d, : len(abs_)] = abs_
                wlo[d] = awlo
                blo[d] = ablo
        else:
            m_w = m_b = 1
            ws = wb = np.zeros((D, 1), np.int32)
            bp = bs = np.zeros((D, 1), np.int32)
            wlo = blo = np.zeros((D, 1), np.int32)
        run = _sharded_chain(self.mesh, buckets, self.k, blk, self.top,
                             shared_alt, m_task, m_ann, c_bucket, compact,
                             aligned, m_w, m_b)
        rows_packed = run(
            jnp.asarray(self.blob.data), alt, dst, srcb, exe, ann_s, ann_e,
            starts, total_res, tl, alo, ws, wb, bp, bs, wlo, blo,
            self.params,
        )
        # decode metadata rides the handle's start/len slots, shaped
        # [(pair_idx, seg_start, hap1_len), ...] per shard
        decode = [
            [
                (pair_idx, packed[d].spans[2 * i][1],
                 shard_progs[d][2 * i].res_len)
                for i, pair_idx in enumerate(pair_idxs)
            ]
            for d, pair_idxs in enumerate(pair_shards)
        ]
        return ChunkHandle("device", n_pairs, None, None, rows_packed,
                           decode=decode)

    def collect(self, handle: ChunkHandle):
        """Blocking fetch + row decode; None for a ``"host"`` handle."""
        from ..downstream.device_resident import _unpack_rows

        if handle.kind == "host":
            return None
        if handle.kind == "empty":
            return {i: [] for i in range(handle.n_samples)}
        # ONE [D, S, top, 8+k] fetch for the whole mesh; the row decode is
        # the same helper the single-device engine uses (no twin drift)
        from ..downstream.device_resident import _decode_rows

        vals, gpos, wins = _unpack_rows(np.asarray(handle.packed))
        out = {}
        for d, shard_decode in enumerate(handle.decode):
            for local_i, (pair_idx, seg_start, hap1_len) in enumerate(
                shard_decode
            ):
                out[pair_idx] = _decode_rows(
                    vals[d, local_i], gpos[d, local_i], wins[d, local_i],
                    seg_start, hap1_len,
                )
        return out

"""Multi-chip cohort execution: sample-axis data parallelism over a mesh.

Haplotype programs are partitioned into one chunk per device (balanced by
result bytes), each chunk packed into the flat SoA form, padded to the shared
bucket shapes, and executed by a single ``shard_map``-jitted program:

* the reference-proteome blob is **replicated** (every chip holds one copy in
  HBM and reads it with local gathers -- no collectives on the hot path),
* task arrays / alt tapes / result tapes are **sharded** on the ``dp`` axis.

This replaces the reference's out-of-process sample sharding
(automation_scripts/parallization_python.py) with one compiled program whose
per-device work is embarrassingly parallel; scaling efficiency is bounded by
chunk balance, not communication.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..compiler.haplotype import RefBlob
from ..runtime.pack import pack_cohort, pad_to_bucket

_FN_CACHE = {}


def _sharded_runner(mesh, out_bucket: int, shared_alt: bool,
                    aligned: bool = False):
    """Build (and cache) the shard_map'd executor for one output bucket.

    ``shared_alt``: the cohort alt tape is a run-wide shared pool --
    replicated like the proteome blob (every chip reads it with local
    gathers) instead of carrying a per-shard alt tape. ``aligned`` runs the
    default word-aligned kernel (runtime/device_engine.aligned_execute_body)
    over per-shard word programs; False keeps the per-byte delta
    formulation (int64 packs, tiny tapes, env opt-out).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from ..utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    key = (tuple(d.id for d in mesh.devices.flat), out_bucket, shared_alt,
           aligned)
    if key in _FN_CACHE:
        return _FN_CACHE[key]

    if aligned:
        from ..runtime.device_engine import aligned_execute_body

        def per_shard(blob, alt, wstart, wbase, bpos, bsrc):
            combined = jnp.concatenate(
                [blob, alt if shared_alt else alt[0]]
            )
            return aligned_execute_body(
                combined, wstart[0], wbase[0], bpos[0], bsrc[0], out_bucket
            )[None, :]

        in_specs = (
            P(),
            P() if shared_alt else P("dp", None),
            P("dp", None), P("dp", None), P("dp", None), P("dp", None),
        )
    else:
        def per_shard(blob, alt, dst, srcb):
            # sharded operands keep a leading dp axis of size 1 in-shard
            combined = jnp.concatenate(
                [blob, alt if shared_alt else alt[0]]
            )
            # covering-task expansion by delta-scatter + cumsum (see
            # runtime/device_engine.py); padding tasks carry dst = iinfo.max
            # -> dropped
            v = srcb[0] - dst[0]
            delta = v - jnp.concatenate([jnp.zeros(1, v.dtype), v[:-1]])
            acc = jnp.zeros(out_bucket, v.dtype).at[dst[0]].add(
                delta, mode="drop"
            )
            j = jnp.arange(out_bucket, dtype=v.dtype)
            gidx = jnp.clip(jnp.cumsum(acc) + j, 0, combined.shape[0] - 1)
            return jnp.take(combined, gidx)[None, :]

        in_specs = (
            P(),
            P() if shared_alt else P("dp", None),
            P("dp", None),
            P("dp", None),
        )

    fn = shard_map(per_shard, mesh=mesh, in_specs=in_specs,
                   out_specs=P("dp", None))
    jitted = jax.jit(fn)
    _FN_CACHE[key] = jitted
    return jitted


def partition_programs(programs, n_shards: int):
    """Balance haplotype programs across shards by result bytes (greedy)."""
    order = sorted(range(len(programs)), key=lambda i: -programs[i].res_len)
    shards = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for i in order:
        s = loads.index(min(loads))
        shards[s].append(i)
        loads[s] += programs[i].res_len
    return shards


@dataclass
class ShardedEngine:
    """Data-parallel executor over a ``dp`` mesh."""

    blob: RefBlob
    mesh: object

    def execute(self, programs) -> list:
        import jax.numpy as jnp

        from ..runtime.pack import program_is_contiguous

        good_mask = [program_is_contiguous(p) for p in programs]
        oracle_results = {}
        if not all(good_mask):
            # isolate malformed programs on the host oracle; the remaining
            # cohort stays on the device path
            from ..runtime import cpu_engine

            oracle_results = {
                i: cpu_engine.execute_tasks(programs[i], self.blob)
                for i, g in enumerate(good_mask) if not g
            }
            if len(oracle_results) == len(programs):
                return [oracle_results[i] for i in range(len(programs))]
        device_ids = [i for i, g in enumerate(good_mask) if g]
        device_programs = [programs[i] for i in device_ids]
        n_shards = self.mesh.devices.size
        shard_local = partition_programs(device_programs, n_shards)
        shard_indices = [
            [device_ids[j] for j in shard] for shard in shard_local
        ]
        packed = [
            pack_cohort([programs[i] for i in idxs], self.blob)
            for idxs in shard_indices
        ]
        if not all(p.contiguous for p in packed):
            # cross-program corruption survived per-program checks: oracle all
            from ..runtime import cpu_engine

            return [cpu_engine.execute_tasks(p, self.blob) for p in programs]
        task_bucket = pad_to_bucket(max(max((len(p.dst) for p in packed)), 1))
        out_bucket = pad_to_bucket(max(max((p.total_res for p in packed)), 1))
        idx_dtype = (
            np.int64
            if any(p.dst.dtype == np.int64 for p in packed)
            else np.int32
        )
        shared_alt = (
            packed[0].alt_key is not None
            and all(p.alt_key == packed[0].alt_key for p in packed)
        )
        D = n_shards
        if shared_alt:
            # run-wide alt pool: one replicated copy, like the proteome blob
            alt = packed[0].alt
            alt_len = len(alt)
        else:
            alt_bucket = pad_to_bucket(max(max((len(p.alt) for p in packed)), 1))
            alt = np.zeros((D, alt_bucket), dtype=np.uint8)
            for d, p in enumerate(packed):
                alt[d, : len(p.alt)] = p.alt
            alt_len = alt_bucket
        from ..runtime.device_engine import use_aligned_exec

        if use_aligned_exec(idx_dtype, out_bucket,
                            len(self.blob.data) + alt_len):
            from ..runtime.device_engine import (
                build_aligned_program,
                pad_aligned_program,
            )

            combined_len = len(self.blob.data) + alt_len
            progs_a = [
                build_aligned_program(p.dst, p.src_biased, p.total_res,
                                      combined_len)
                for p in packed
            ]
            b_bucket = pad_to_bucket(
                max(max((len(bp) for _w, _b, bp, _s in progs_a)), 1)
            )
            ws = np.empty((D, task_bucket), np.int32)
            wb = np.empty((D, task_bucket), np.int32)
            bp = np.empty((D, b_bucket), np.int32)
            bs = np.empty((D, b_bucket), np.int32)
            for d, pa in enumerate(progs_a):
                ws[d], wb[d], bp[d], bs[d] = pad_aligned_program(
                    *pa, task_bucket, out_bucket, b_bucket
                )
            run = _sharded_runner(self.mesh, out_bucket, shared_alt,
                                  aligned=True)
            out = np.asarray(
                run(jnp.asarray(self.blob.data), alt, ws, wb, bp, bs)
            )
        else:
            dst = np.full((D, task_bucket), np.iinfo(idx_dtype).max,
                          dtype=idx_dtype)
            srcb = np.zeros((D, task_bucket), dtype=idx_dtype)
            for d, p in enumerate(packed):
                dst[d, : len(p.dst)] = p.dst
                srcb[d, : len(p.src_biased)] = p.src_biased
            run = _sharded_runner(self.mesh, out_bucket, shared_alt)
            out = np.asarray(run(jnp.asarray(self.blob.data), alt, dst, srcb))
        results = [None] * len(programs)
        for i, tape in oracle_results.items():
            results[i] = tape
        for d, (p, idxs) in enumerate(zip(packed, shard_indices)):
            tape = out[d]
            for (local_idx, start, end) in p.spans:
                results[idxs[local_idx]] = tape[start:end]
        return results

"""Fully device-resident neoantigen pipeline: tapes never leave HBM.

The FASTA path must move every output byte to host disk. The neoantigen
workload is different: its *output* is per-sample top-k peptide rows, a few
hundred KB per cohort. This module keeps the whole compute chain on device --

    execute (gather)  ->  alt/validity masks  ->  dense bf16 matmul scoring
    ->  per-sample top-k

-- and fetches only ``[S, top]`` scores/positions plus ``[S, top, k]`` peptide
bytes, so the accelerator is load-bearing end-to-end (the role the
reference stubs at src/data_structures/InternalRep/gir.rs:283-299).

The kernel design is GATHER-FREE except the one unavoidable execute gather
and the tiny [S, top, k] result fetch: XLA lowers a vectorized binary search
to log2(n) serialized gather rounds and large random gathers are costly,
while scatter-adds at TASK granularity, cumsums and multi-operand sorts are
cheap. (That balance was measured on another accelerator and is not yet
measured on the H100.) So every per-task -> per-byte mapping uses
delta-scatter + cumsum ("segment expansion"), never per-byte binary
search:

* ``expand_delta``: tape[j] = vals[t(j)] for the task/span t covering byte j,
  computed by scattering first-difference deltas at segment starts and
  prefix-summing. Coincident starts (zero-length tasks) telescope to the
  last task's value, matching searchsorted(side='right')-1 semantics.
* execute: j + expand_delta(srcb - dst) is each byte's combined-tape source;
  one byte gather materializes the tape.
* alt-byte mask: expand the exe flag per byte (a task is alt-sourced iff its
  biased source points past the proteome blob, src_biased >= blob_len);
  mutation = alt-sourced and not the compiler's '.' filler. Identical to
  peptides.alt_byte_mask by construction.
* window validity: expand each annotation span's END per byte; a k-window at
  j is valid iff j+k <= span_end[j] (spans tile the tape).
* mutated-window range query: prefix-sum the alt mask once; the in-window
  count is a SHIFTED-SLICE difference (pad + slice), not an indexed gather.
* the whole dense pass is TILED: one ``lax.map`` streams the tape in
  ``blk``-lane tiles, each rebuilding its expansions from a sliced task
  range (host-computed slice table) + precomputed carries and scoring its
  windows immediately -- nothing of size ``[out, k]`` or full-length int32
  is materialized, so cost stays linear in chunk size.
* scaffold-width heads score ALL tape positions (invalid windows -> NEG; no
  data-dependent host sync, no per-chunk shape recompiles); WIDE heads take
  the compacted path (:func:`_compact_core`): candidates to the front of a
  1-key position sort, a static host-bounded candidate bucket scored via a
  4-word-aligned window gather. The folded one-hot head
  (scoring.score_windows) makes scoring one big matmul per tile.
* per-sample top-k: SEGMENTED: per-block stable sorts + per-(block,
  sample) top-``top`` pruning + a small global sort
  (:func:`_rank_segmented`), falling back to one stable lexicographic sort by (sample_id asc, score
  desc) for small buckets. Ties keep ascending tape position in both
  paths, matching the host path's stable argsort tie order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from ..compiler.haplotype import RefBlob
from ..runtime.pack import pack_cohort, pad_to_bucket
from .report import _span_of
from .scoring import init_params, layer_names, score_windows

NEG = np.float32(-np.inf)


def dense_blk(out_bucket: int, params: dict) -> int:
    """lax.map tile size for the dense pass, scaled so the widest fp32
    hidden activation [blk, H] stays ~256 MB regardless of head width
    (wide heads at a fixed 1<<19 block would materialize multi-GB
    intermediates). The 256 MB target was tuned on another accelerator and
    is not yet measured on the H100. VCF2PROT_DENSE_BLK caps it for
    tuning."""
    import os

    env = os.environ.get("VCF2PROT_DENSE_BLK")
    if env:  # explicit override for tuning runs
        blk = 1 << (max(int(env), 1).bit_length() - 1)
        return min(out_bucket, max(blk, 1 << 13))
    width = max(
        (params[name].shape[1] for name in layer_names(params)), default=128
    )
    blk = max((1 << 28) // (4 * max(int(width), 128)), 1)
    blk = 1 << (blk.bit_length() - 1)  # floor to a power of two
    blk = max(1 << 13, blk)
    # out_bucket is a power of two, so blk <= out_bucket always divides it
    return min(out_bucket, blk, 1 << 19)


def _expand_delta(jnp, vals, starts, out_len):
    """tape[j] = vals[t(j)] where t(j) is the LAST segment whose start is
    <= j: scatter first-difference deltas at segment starts, prefix-sum.

    Matches ``searchsorted(starts, j, 'right') - 1`` exactly (coincident
    starts telescope so the last segment wins) at segment-count scatter cost
    instead of per-byte binary search. Out-of-range starts (bucket padding)
    are dropped.
    """
    v = vals.astype(jnp.int32)
    delta = v - jnp.concatenate([jnp.zeros(1, jnp.int32), v[:-1]])
    acc = jnp.zeros(out_len, jnp.int32).at[starts].add(delta, mode="drop")
    return jnp.cumsum(acc)


def _tile_deltas(jnp, vals, starts, blk: int, n_tiles: int):
    """Per-tile carry state for a delta expansion, O(tasks): the cumsum
    carry entering tile ``t`` is the sum of all deltas scattered at starts
    below ``t*blk``, computed by binning deltas per tile + one tiny cumsum.
    Returns ``(delta [tasks], carry [n_tiles])``; padded entries (starts =
    int32 max) land out of the bin range and drop, exactly like the global
    scatter's ``mode="drop"``."""
    v = vals.astype(jnp.int32)
    delta = v - jnp.concatenate([jnp.zeros(1, jnp.int32), v[:-1]])
    bins = jnp.zeros(n_tiles, jnp.int32).at[starts // blk].add(
        delta, mode="drop"
    )
    carry = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(bins)[:-1]]
    )
    return delta, carry


def tile_slices(starts, blk: int, n_tiles: int, overlap: int):
    """Host-side per-tile slice table for a sorted segment-start array:
    ``lo[t]`` = first entry with start >= t*blk, and the static cap
    ``m`` = max entries any tile's ``[t*blk, t*blk + blk + overlap)`` range
    holds. Each device tile then scatters only its own slice instead of
    re-scanning the whole array (the difference between O(tasks) and
    O(tasks * n_tiles) scatter updates across the map)."""
    s = np.asarray(starts)
    a = np.arange(n_tiles, dtype=np.int64) * blk
    lo = np.searchsorted(s, a, side="left")
    hi = np.searchsorted(s, a + blk + overlap, side="left")
    m = int((hi - lo).max()) if n_tiles else 1
    return lo.astype(np.int32), max(m, 1)


def _dense_core(combined, dst, srcb, exe, ann_starts, ann_ends, params,
                total_res, tile_lo, ann_lo, aligned=None, *,
                out_bucket: int, k: int, blk: int, m_task: int, m_ann: int,
                m_w: int = 0, m_b: int = 0, score: bool = True):
    """Execute + masks + dense scoring over one chunk, all static-shaped.

    Scores EVERY tape position (invalid windows -> NEG): at scaffold width,
    scoring the ~10x extra windows as one matmul was cheaper than
    compacting candidates first on the accelerator this was tuned on (not
    yet measured on the H100), and it removes the only data-dependent host
    sync plus the candidate-count shape bucket. Pure jax; shared by the
    single-device jit (:func:`_dense_fn`) and the dp-sharded chain
    (parallel/sharded_neoantigen.py).

    TILED: the whole pass streams the tape in ``blk``-lane tiles inside
    one ``lax.map`` -- each tile rebuilds its expansions locally (scatter
    the task deltas whose starts fall in the tile, add the precomputed
    carry from :func:`_tile_deltas`, cumsum ``blk + k - 1`` lanes) and
    scores its windows immediately. Nothing of size ``[out, k]`` or
    full-length int32 is ever materialized, only the ``tape/cand/scores``
    outputs (6 B/lane), so dense cost stays ~linear in chunk size instead
    of growing with the HBM working set.
    Tiles overlap by ``k - 1`` lanes so every window is formed from
    statically-sliced local bytes; overlap lanes past the last real byte
    gather junk, but any window reading them fails ``j + k <= total_res``
    and scores NEG, exactly like the old zero-fill shift.
    """
    import jax
    import jax.numpy as jnp

    n_tiles = out_bucket // blk
    L = blk + k - 1
    if aligned is None:
        delta_base, carry_base = _tile_deltas(
            jnp, srcb - dst, dst, blk, n_tiles
        )
    else:
        # word-aligned execute (the FASTA executor's aligned32 formulation,
        # tiled): word-granularity delta expansion + two aligned u32 loads
        # per output word + a small per-tile boundary-byte fix-up -- ~2x
        # fewer gather lanes than the per-byte execute (device_engine.py,
        # build_aligned_program)
        wstart, wbase, bpos, bsrc, wtile_lo, btile_lo = aligned
        blk_w = blk // 4
        Lw = (L + 3) // 4
        delta_w, carry_w = _tile_deltas(jnp, wbase, wstart, blk_w, n_tiles)
        cw = jax.lax.bitcast_convert_type(
            combined[: (combined.shape[0] // 4) * 4].reshape(-1, 4),
            jnp.uint32,
        ).reshape(-1)
    delta_exe, carry_exe = _tile_deltas(jnp, exe, dst, blk, n_tiles)
    delta_span, carry_span = _tile_deltas(
        jnp, ann_ends, ann_starts, blk, n_tiles
    )

    def expand_local(a, delta, starts, carry_t, length):
        # starts - a wraps for the int32-max padding sentinel, but the
        # guard routes every out-of-tile start to the dropped slot (and
        # drops any out-of-range entry dynamic_slice's clamping re-included)
        idx = jnp.where(
            (starts >= a) & (starts < a + length), starts - a, length
        )
        acc = jnp.zeros(length, jnp.int32).at[idx].add(delta, mode="drop")
        return carry_t + jnp.cumsum(acc)

    def tile(t):
        a = t * blk
        lo = tile_lo[t]
        d_s = jax.lax.dynamic_slice(dst, (lo,), (m_task,))
        de_s = jax.lax.dynamic_slice(delta_exe, (lo,), (m_task,))
        al = ann_lo[t]
        as_s = jax.lax.dynamic_slice(ann_starts, (al,), (m_ann,))
        ds_s = jax.lax.dynamic_slice(delta_span, (al,), (m_ann,))
        jg = a + jnp.arange(L, dtype=jnp.int32)
        if aligned is None:
            db_s = jax.lax.dynamic_slice(delta_base, (lo,), (m_task,))
            base = expand_local(a, db_s, d_s, carry_base[t], L)
            g = jnp.clip(base + jg, 0, combined.shape[0] - 1)
            tape_seg = jnp.take(combined, g)
        else:
            aw = t * blk_w
            wlo = wtile_lo[t]
            ws_s = jax.lax.dynamic_slice(wstart, (wlo,), (m_w,))
            wd_s = jax.lax.dynamic_slice(delta_w, (wlo,), (m_w,))
            base_w = expand_local(aw, wd_s, ws_s, carry_w[t], Lw)
            jw = (aw + jnp.arange(Lw, dtype=jnp.int32)) * 4
            g = jnp.clip(base_w + jw, 0, combined.shape[0] - 8)
            gi = g >> 2
            w0 = cw[gi]
            w1 = cw[gi + 1]
            sh = ((g & 3) * 8).astype(jnp.uint32)
            words = jnp.where(sh == 0, w0, (w0 >> sh) | (w1 << (32 - sh)))
            seg = jax.lax.bitcast_convert_type(
                words[:, None], jnp.uint8
            ).reshape(-1)[:L]
            blo = btile_lo[t]
            bp_s = jax.lax.dynamic_slice(bpos, (blo,), (m_b,))
            bs_s = jax.lax.dynamic_slice(bsrc, (blo,), (m_b,))
            bidx = jnp.where((bp_s >= a) & (bp_s < a + L), bp_s - a, L)
            bvals = jnp.take(
                combined, jnp.clip(bs_s, 0, combined.shape[0] - 1)
            )
            tape_seg = seg.at[bidx].set(bvals, mode="drop")
        is_alt = expand_local(a, de_s, d_s, carry_exe[t], L)
        alt = (is_alt > 0) & (tape_seg != ord(".")) & (jg < total_res)
        # mutated-window range query: local prefix sum over the
        # overlapped segment; the carry cancels in the difference
        cum = jnp.cumsum(alt.astype(jnp.int32))
        in_win = cum[k - 1:] - jnp.concatenate(
            [jnp.zeros(1, jnp.int32), cum]
        )[:blk]
        span_end = expand_local(a, ds_s, as_s, carry_span[t], blk)
        jm = jg[:blk]
        cand = (jm + k <= span_end) & (jm + k <= total_res) & (in_win > 0)
        if not score:  # mask-only pass for the compacted chain
            return tape_seg[:blk], cand
        # windows are k static slices of the overlapped local segment
        win = jnp.stack([tape_seg[i:i + blk] for i in range(k)], axis=1)
        scores = score_windows(win, params)
        return tape_seg[:blk], cand, jnp.where(cand, scores, NEG)

    outs = jax.lax.map(tile, jnp.arange(n_tiles, dtype=jnp.int32))
    return tuple(o.reshape(out_bucket) for o in outs)


def _pack_rows(jnp, vals, gpos, wins):
    """Bitcast-pack (scores f32[..., top], positions i32[..., top], peptide
    bytes u8[..., top, k]) into ONE u8[..., top, 8+k] buffer.

    One packed buffer per chunk makes one device->host fetch instead of
    three. Unpacked by :func:`_unpack_rows`.
    """
    import jax

    vb = jax.lax.bitcast_convert_type(vals, jnp.uint8)
    gb = jax.lax.bitcast_convert_type(gpos.astype(jnp.int32), jnp.uint8)
    return jnp.concatenate([vb, gb, wins], axis=-1)


def _unpack_rows(buf):
    """Host twin of :func:`_pack_rows`: u8[..., top, 8+k] -> (f32 scores,
    i32 positions, u8[..., top, k] bytes)."""
    lead = buf.shape[:-1]
    vals = np.ascontiguousarray(buf[..., :4]).view(np.float32).reshape(lead)
    gpos = np.ascontiguousarray(buf[..., 4:8]).view(np.int32).reshape(lead)
    return vals, gpos, buf[..., 8:]


def _decode_rows(vals, gpos, wins, seg_start: int, hap1_len: int):
    """One sample's ranked rows ``[(score, hap, hap_pos, peptide), ...]``
    from its unpacked ``[top]`` slices — the SINGLE row-decode used by both
    the single-device and dp-sharded engines (they must never drift).

    The ranked prefix ends at the FIRST ``-inf`` row: pad rows sort last,
    and a pathological real ``-inf`` score (overflowing trained weights)
    also ends the prefix, exactly like the original break-based decode.
    """
    inf = np.nonzero(vals == -np.inf)[0]
    n = int(inf[0]) if inf.size else vals.shape[0]
    local = gpos[:n].astype(np.int64) - seg_start
    hap = np.where(local < hap1_len, 1, 2)
    hpos = np.where(local < hap1_len, local, local - hap1_len)
    return [
        (float(vals[r]), int(hap[r]), int(hpos[r]), bytes(wins[r]))
        for r in range(n)
    ]


def rank_blk(out_bucket: int) -> int:
    """Block size for the segmented rank sort (power of two, divides the
    power-of-two ``out_bucket``); env-tunable for measurement. The 2^16
    default was swept on another accelerator at 2^27 lanes and is not yet
    measured on the H100."""
    import os

    b = int(os.environ.get("VCF2PROT_RANK_BLK", str(1 << 16)))
    b = 1 << (max(b, 1).bit_length() - 1)
    return min(out_bucket, b)


def count_spb(sample_starts, blk: int) -> int:
    """Static bound on distinct samples intersecting any ``blk``-lane rank
    block: (max segment starts inside one block) + 1 (the segment spanning
    the block start). Computed host-side from the chunk's sample segment
    starts; folded over chunks into :class:`Buckets` for shape stability."""
    starts = np.asarray(sample_starts, np.int64)
    if starts.size == 0:
        return 1
    return int(np.bincount(starts // blk).max()) + 1


def _rank_segmented(jax, jnp, sid, negsc, pos, *, out_bucket: int,
                    s_bucket: int, top: int, blk: int, spb: int):
    """Segmented per-sample top-``top``: per-block 2-key stable sorts over
    ``blk`` lanes instead of one global sort over ``out_bucket`` lanes.

    Within each block, each sample's block-local top-``top`` is a superset
    of its contribution to the global top-``top`` (any row outside the
    block-local top has >= top better rows in that block alone), so pruning
    to ``spb * top`` rows per block before a small global sort is exact --
    including tie order: block-local stability keeps ascending position,
    and the flatten order (block-major) presents equal (sid, score) rows to
    the final stable sort in ascending position. Sorted bytes drop from
    ``12 * out_bucket`` at log2(out) depth to ``12 * out_bucket`` at
    log2(blk) depth plus a ~(out/(spb*top*nb))x smaller global sort.
    Returns the (sid, -score, pos) triple sorted by (sample asc, score
    desc), length ``nb * spb * top``.
    """
    nb = out_bucket // blk
    sid_s, neg_s, pos_s = jax.lax.sort(
        (sid.reshape(nb, blk), negsc.reshape(nb, blk),
         pos.reshape(nb, blk)),
        dimension=1, num_keys=2, is_stable=True,
    )
    change = jnp.concatenate(
        [jnp.ones((nb, 1), bool), sid_s[:, 1:] != sid_s[:, :-1]], axis=1
    )
    slot = jnp.cumsum(change.astype(jnp.int32), axis=1) - 1
    # run_start[b, s] = first lane of the s-th distinct-sid run (slot is
    # sorted per block, so a batched binary search beats any scatter)
    run_start = jax.vmap(
        lambda sl: jnp.searchsorted(
            sl, jnp.arange(spb, dtype=jnp.int32), side="left"
        )
    )(slot).astype(jnp.int32)
    idx = (
        run_start[:, :, None]
        + jnp.arange(top, dtype=jnp.int32)[None, None, :]
    )
    idx_f = jnp.clip(idx, 0, blk - 1).reshape(nb, spb * top)
    sid_g = jnp.take_along_axis(sid_s, idx_f, axis=1)
    neg_g = jnp.take_along_axis(neg_s, idx_f, axis=1)
    pos_g = jnp.take_along_axis(pos_s, idx_f, axis=1)
    sid0 = jnp.take_along_axis(
        sid_s, jnp.clip(run_start, 0, blk - 1), axis=1
    )
    ok = (
        (idx < blk)
        & (run_start[:, :, None] < blk)
        & (sid_g.reshape(nb, spb, top) == sid0[:, :, None])
        & (sid0[:, :, None] < s_bucket)
    ).reshape(nb, spb * top)
    sid_c = jnp.where(ok, sid_g, s_bucket).reshape(-1)
    neg_c = jnp.where(ok, neg_g, jnp.inf).reshape(-1)
    pos_c = jnp.where(ok, pos_g, 0).reshape(-1)
    return jax.lax.sort((sid_c, neg_c, pos_c), num_keys=2, is_stable=True)


def use_segmented_rank(out_bucket: int, top: int, blk: int,
                       spb: int) -> bool:
    """Gate for the segmented rank path: the pruned per-block rows must be
    a small fraction of the block (else the extra pass costs more than the
    shallower sort saves), and multiple blocks must exist."""
    import os

    return (
        os.environ.get("VCF2PROT_SEG_RANK", "1") != "0"
        and spb > 0
        and out_bucket > blk
        and spb * top * 4 <= blk
    )


def _rank_core(tape, cand, scores, sample_starts, *, out_bucket: int, k: int,
               s_bucket: int, top: int, spb: int = 0):
    """Per-sample top-``top``; see :func:`_dense_core` for the sharing
    contract. ``spb`` > 0 (the :class:`Buckets` per-block sample bound)
    enables the segmented sort (:func:`_rank_segmented`) when the gate
    accepts; otherwise one global stable lexicographic sort."""
    import jax
    import jax.numpy as jnp

    j = jnp.arange(out_bucket, dtype=jnp.int32)
    sid = _expand_delta(
        jnp,
        jnp.arange(s_bucket, dtype=jnp.int32),
        sample_starts,
        out_bucket,
    )
    sid = jnp.where(cand, sid, s_bucket)
    blk = rank_blk(out_bucket)
    if use_segmented_rank(out_bucket, top, blk, spb):
        sid_s, negsc_s, pos_s = _rank_segmented(
            jax, jnp, sid, -scores, j, out_bucket=out_bucket,
            s_bucket=s_bucket, top=top, blk=blk, spb=spb,
        )
        n_rows = sid_s.shape[0]
    else:
        # one stable lexicographic sort: (sample asc, score desc);
        # stability over the position-ordered input keeps score ties in
        # ascending tape position, the host path's tie order
        sid_s, negsc_s, pos_s = jax.lax.sort(
            (sid, -scores, j), num_keys=2, is_stable=True
        )
    return _select_top(
        jnp, tape, sid_s, negsc_s, pos_s, s_bucket=s_bucket, top=top, k=k
    )


def _select_top(jnp, tape, sid_s, negsc_s, pos_s, *, s_bucket: int,
                top: int, k: int):
    """Per-sample row extraction from a (sid asc, score desc)-sorted triple:
    segment starts by binary search, ``top`` rows per segment, peptide bytes
    gathered from the tape. Shared by the dense and compacted rank paths."""
    n_rows = sid_s.shape[0]
    seg = jnp.searchsorted(
        sid_s, jnp.arange(s_bucket, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    idx = seg[:, None] + jnp.arange(top, dtype=jnp.int32)[None, :]
    idx_c = jnp.clip(idx, 0, n_rows - 1)
    valid = (idx < n_rows) & (
        sid_s[idx_c] == jnp.arange(s_bucket, dtype=jnp.int32)[:, None]
    )
    vals = jnp.where(valid, -negsc_s[idx_c], NEG)
    gpos = jnp.where(valid, pos_s[idx_c], 0)
    wins = tape[
        gpos[:, :, None] + jnp.arange(k, dtype=jnp.int32)[None, None, :]
    ]
    return vals, gpos, wins


def cand_bound(programs, k: int) -> int:
    """Host-side upper bound on candidate windows in a chunk, O(tasks): a
    candidate window must overlap an alt-sourced byte, and an alt task of
    length L can be overlapped by at most L + k - 1 window starts ('.'
    filler and span/validity clipping only shrink the true count)."""
    total = 0
    for p in programs:
        exe = np.asarray(p.exe) == 1
        n_exe = int(exe.sum())
        if n_exe:
            total += int(np.asarray(p.length)[exe].sum()) + (k - 1) * n_exe
    return total


def use_compact(params: dict, k: int, out_bucket: int,
                c_bucket: int) -> bool:
    """Gate for the compacted scoring path: worth it only when the head is
    wide enough that scoring all ~out/C extra windows costs more than the
    compaction sort + window gather, and the candidate bound is actually a
    small fraction of the tape. The aligned 4-word window extraction needs
    k <= 13. The 2e5 FLOP-per-window threshold was tuned on another
    accelerator and is not yet measured on the H100. VCF2PROT_COMPACT=1
    forces on (tests), =0 off, default auto."""
    import os

    from ..utils.roofline import scoring_flops_per_window

    env = os.environ.get("VCF2PROT_COMPACT", "auto")
    if env == "0":
        return False
    if k > 13 or c_bucket * 4 > out_bucket:
        return False
    if env == "1":
        return True
    return scoring_flops_per_window(params) >= 2e5


def _compact_core(combined, dst, srcb, exe, ann_starts, ann_ends,
                  sample_starts, params, total_res, tile_lo, ann_lo, *,
                  out_bucket: int, k: int, blk: int, m_task: int,
                  m_ann: int, c_bucket: int, s_bucket: int, top: int):
    """Compacted chain: mask-only tiled pass, candidates to the front of a
    1-key sort, score ONLY the static candidate bucket, rank over it.

    The dense pass scores ~11x more windows than the candidate set on the
    synthetic cohorts; at wide heads those FLOPs dominate, so this path
    pays one cheap single-operand sort (ascending position key; candidates
    keyed ``j``, others ``j + out_bucket``) plus a 4-word-aligned window
    gather (4 u32 lanes per window, byte offset resolved by a 4-way
    select -- never a per-byte gather) to shrink the scoring batch to
    ``c_bucket``. ``c_bucket`` comes from the host-side :func:`cand_bound`
    (an upper bound), so no candidate can overflow and no data-dependent
    host sync or fallback branch is needed. Scores are bit-identical to
    the dense path's (same windows, same per-row reduction); the rank sort
    runs over ``c_bucket`` lanes instead of ``out_bucket``.
    """
    import jax
    import jax.numpy as jnp

    tape, cand = _dense_core(
        combined, dst, srcb, exe, ann_starts, ann_ends, params, total_res,
        tile_lo, ann_lo, out_bucket=out_bucket, k=k, blk=blk,
        m_task=m_task, m_ann=m_ann, score=False,
    )
    j = jnp.arange(out_bucket, dtype=jnp.int32)
    sid = _expand_delta(
        jnp, jnp.arange(s_bucket, dtype=jnp.int32), sample_starts,
        out_bucket,
    )
    sid = jnp.where(cand, sid, s_bucket)
    key = jnp.where(cand, j, j + out_bucket)
    key_s, sid_sorted = jax.lax.sort((key, sid), num_keys=1)
    key_c = jax.lax.slice(key_s, (0,), (c_bucket,))
    sid_c = jax.lax.slice(sid_sorted, (0,), (c_bucket,))
    real = key_c < out_bucket
    pos_c = jnp.where(real, key_c, 0)
    # aligned window extraction: 4 u32 words cover any k<=13 window; the
    # in-word byte offset collapses to a 4-way select over static slices
    tw = jax.lax.bitcast_convert_type(
        jnp.concatenate([tape, jnp.zeros(16, jnp.uint8)])
        [: (out_bucket // 4 + 4) * 4].reshape(-1, 4),
        jnp.uint32,
    ).reshape(-1)
    w4 = tw[(pos_c >> 2)[:, None] + jnp.arange(4, dtype=jnp.int32)[None, :]]
    b16 = jax.lax.bitcast_convert_type(
        w4[..., None], jnp.uint8
    ).reshape(c_bucket, 16)
    off = jnp.broadcast_to(
        (pos_c & 3).astype(jnp.int32)[:, None], (c_bucket, k)
    )
    win = jax.lax.select_n(off, *(b16[:, i:i + k] for i in range(4)))
    cblk = min(blk, c_bucket)
    scores_c = jax.lax.map(
        lambda w: score_windows(w, params),
        win.reshape(c_bucket // cblk, cblk, k),
    ).reshape(c_bucket)
    scores_c = jnp.where(real, scores_c, NEG)
    # rank over the compacted lanes: same stable (sample asc, score desc)
    # sort; pos_c ascends pre-sort, so tie order matches the dense path
    sid_r, neg_r, pos_r = jax.lax.sort(
        (sid_c, -scores_c, pos_c), num_keys=2, is_stable=True
    )
    return _select_top(
        jnp, tape, sid_r, neg_r, pos_r, s_bucket=s_bucket, top=top, k=k
    )


@functools.lru_cache(maxsize=32)
def _compact_fn(out_bucket: int, k: int, blk: int, m_task: int, m_ann: int,
                c_bucket: int, s_bucket: int, top: int):
    import jax
    import jax.numpy as jnp

    from ..utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    @jax.jit
    def run(combined, dst, srcb, exe, ann_starts, ann_ends, sample_starts,
            params, total_res, tile_lo, ann_lo):
        vals, gpos, wins = _compact_core(
            combined, dst, srcb, exe, ann_starts, ann_ends, sample_starts,
            params, total_res, tile_lo, ann_lo, out_bucket=out_bucket,
            k=k, blk=blk, m_task=m_task, m_ann=m_ann, c_bucket=c_bucket,
            s_bucket=s_bucket, top=top,
        )
        return _pack_rows(jnp, vals, gpos, wins)

    return run


@functools.lru_cache(maxsize=32)
def _dense_fn(out_bucket: int, k: int, blk: int, m_task: int, m_ann: int):
    import jax

    from ..utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    @jax.jit
    def run(combined, dst, srcb, exe, ann_starts, ann_ends, params,
            total_res, tile_lo, ann_lo):
        return _dense_core(
            combined, dst, srcb, exe, ann_starts, ann_ends, params,
            total_res, tile_lo, ann_lo, out_bucket=out_bucket, k=k, blk=blk,
            m_task=m_task, m_ann=m_ann,
        )

    return run


@functools.lru_cache(maxsize=32)
def _dense_fn_aligned(out_bucket: int, k: int, blk: int, m_task: int,
                      m_ann: int, m_w: int, m_b: int):
    import jax

    from ..utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    @jax.jit
    def run(combined, dst, srcb, exe, ann_starts, ann_ends, params,
            total_res, tile_lo, ann_lo, wstart, wbase, bpos, bsrc,
            wtile_lo, btile_lo):
        return _dense_core(
            combined, dst, srcb, exe, ann_starts, ann_ends, params,
            total_res, tile_lo, ann_lo,
            aligned=(wstart, wbase, bpos, bsrc, wtile_lo, btile_lo),
            out_bucket=out_bucket, k=k, blk=blk, m_task=m_task,
            m_ann=m_ann, m_w=m_w, m_b=m_b,
        )

    return run


@functools.lru_cache(maxsize=32)
def _rank_fn(out_bucket: int, k: int, s_bucket: int, top: int,
             spb: int = 0):
    import jax
    import jax.numpy as jnp

    from ..utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    @jax.jit
    def run(tape, cand, scores, sample_starts):
        vals, gpos, wins = _rank_core(
            tape, cand, scores, sample_starts,
            out_bucket=out_bucket, k=k, s_bucket=s_bucket, top=top,
            spb=spb,
        )
        return _pack_rows(jnp, vals, gpos, wins)

    return run


def _chunk_annotation_spans(programs, spans):
    """Chunk-coordinate annotation (starts, ends), asserting span tiling (the
    device validity rule depends on it); returns None if tiling is violated
    (caller falls back to the host path)."""
    starts, ends = [], []
    for (p_idx, seg_start, seg_end), prog in zip(spans, programs):
        ann = prog.annotations
        if hasattr(ann, "starts"):
            a_st = np.asarray(ann.starts)
            a_en = np.asarray(ann.ends)
        else:
            a_st = np.fromiter((s for _n, s, _e in ann), np.int64, len(ann))
            a_en = np.fromiter((e for _n, _s, e in ann), np.int64, len(ann))
        if len(a_st):
            if (
                int(a_st[0]) != 0
                or int(a_en[-1]) != seg_end - seg_start
                or not np.all(a_st[1:] == a_en[:-1])
            ):
                return None
        elif seg_end != seg_start:
            return None
        starts.append(a_st + seg_start)
        ends.append(a_en + seg_start)
    if not starts:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (
        np.concatenate(starts).astype(np.int32),
        np.concatenate(ends).astype(np.int32),
    )


class Buckets(NamedTuple):
    """Static device shapes for one run.

    Every jitted call retraces and compiles per distinct input-shape
    tuple, so a multi-chunk cohort must not present per-chunk residual
    shapes. The driver computes one Buckets over ALL chunks (max per axis,
    power-of-two padded) and every chunk runs at those shapes -- at most
    one compile per jitted function per run, at the price of scoring the
    padded tail.
    """

    out: int      # result-tape lanes
    tasks: int    # task SoA rows
    ann: int      # annotation spans
    samples: int  # per-chunk sample count
    alt: int      # chunk alt-tape bytes (combined = blob || alt)
    spb: int = 1  # samples-per-rank-block bound (count_spb, run-wide max)
    cand: int = 1  # candidate-window bound (cand_bound, run-wide max)
    m_task: int = 1  # per-tile task slice cap (tile_slices, run-wide max)
    m_ann: int = 1   # per-tile annotation slice cap
    bpos: int = 1    # aligned-execute boundary-byte list length
    m_w: int = 1     # per-tile word-task slice cap (aligned execute)
    m_b: int = 1     # per-tile boundary-byte slice cap (aligned execute)


def _chunk_sample_starts(progs):
    """Chunk-coordinate segment starts of each sample (pair), from program
    result lengths alone (matches pack_cohort's spans for contiguous
    chunks; non-contiguous chunks fall back to host at dispatch anyway)."""
    lens = np.fromiter((p.res_len for p in progs), np.int64, len(progs))
    ends = np.cumsum(lens)
    return np.concatenate([[0], ends[:-1]])[::2]


def _chunk_concat_starts(progs):
    """Chunk-coordinate concatenated task dsts and annotation starts (both
    sorted ascending by the tiling invariant), for per-tile slice sizing."""
    dsts, anns = [], []
    off = 0
    for p in progs:
        dsts.append(np.asarray(p.dst, np.int64) + off)
        ann = p.annotations
        if hasattr(ann, "starts"):
            a_st = np.asarray(ann.starts, np.int64)
        else:
            a_st = np.fromiter((s for _n, s, _e in ann), np.int64, len(ann))
        anns.append(a_st + off)
        off += p.res_len
    z = np.zeros(0, np.int64)
    return (
        np.concatenate(dsts) if dsts else z,
        np.concatenate(anns) if anns else z,
    )


def use_aligned_dense(out_bucket: int, combined_len: int) -> bool:
    """Gate for the word-aligned execute inside the tiled dense pass: the
    FASTA executor's preconditions (use_aligned_exec).
    VCF2PROT_ALIGNED_DENSE=0 turns it off."""
    import os

    from ..runtime.device_engine import use_aligned_exec

    return os.environ.get("VCF2PROT_ALIGNED_DENSE", "1") != "0" and (
        use_aligned_exec(np.int32, out_bucket, combined_len)
    )


def aligned_dense_inputs(dst, src_biased, total_res: int, combined_len: int,
                         blk: int, n_tiles: int, k: int):
    """Host-side aligned-execute inputs for one chunk: the word program
    (build_aligned_program) plus per-tile slice tables and caps. Returns
    ``(ws, wb, bp, bs, wlo, blo, m_w, m_b)`` with unpadded arrays."""
    from ..runtime.device_engine import build_aligned_program

    ws, wb, bp, bs = build_aligned_program(
        dst, src_biased, total_res, combined_len
    )
    L = blk + k - 1
    blk_w = blk // 4
    Lw = (L + 3) // 4
    wlo, m_w = tile_slices(ws, blk_w, n_tiles, Lw - blk_w)
    blo, m_b = tile_slices(bp, blk, n_tiles, k - 1)
    return (ws, wb, bp.astype(np.int32), bs.astype(np.int32), wlo, blo,
            m_w, m_b)


def run_buckets(programs, chunks, k: int = 9, params=None,
                blob=None) -> Buckets:
    """Fold per-chunk shape needs into one run-wide Buckets. ``params``
    (the scoring head) sizes the dense tile width, letting the per-tile
    task/annotation slice caps fold run-wide too; ``blob`` additionally
    lets the aligned-execute word program's shapes fold (a per-chunk pack,
    exactly what dispatch will build). Without them the caps default and
    each chunk sizes its own (same shapes when chunks are homogeneous)."""
    out = tasks = ann = samples = alt = spb = cand = 1
    m_task = m_ann = 1
    pooled = bool(programs) and all(p.pooled for p in programs)
    starts_per_chunk = []
    for chunk in chunks:
        progs = [programs[i] for i in chunk]
        out = max(out, sum(p.res_len for p in progs))
        tasks = max(tasks, sum(p.n_tasks for p in progs))
        ann = max(ann, sum(len(p.annotations) for p in progs))
        samples = max(samples, len(progs) // 2)
        cand = max(cand, cand_bound(progs, k))
        # pooled programs all reference ONE shared alt pool; non-pooled
        # chunks concatenate per-program alt tapes (pack_cohort)
        alt = max(
            alt,
            len(progs[0].alt) if pooled and progs
            else sum(len(p.alt) for p in progs),
        )
        starts_per_chunk.append(_chunk_sample_starts(progs))
    out_b = pad_to_bucket(out)
    blk = rank_blk(out_b)
    for starts in starts_per_chunk:
        spb = max(spb, count_spb(starts, blk))
    bpos = m_w = m_b = 1
    if params is not None:
        dblk = dense_blk(out_b, params)
        n_tiles = out_b // dblk
        # fold the aligned-execute word-program shapes with the exact
        # inputs dispatch will use (combined_len is constant run-wide:
        # blob + the folded alt bucket)
        combined_len = (
            len(blob.data) + pad_to_bucket(alt) if blob is not None else 0
        )
        fold_aligned = blob is not None and use_aligned_dense(
            out_b, combined_len
        )
        if fold_aligned:
            from ..runtime.pack import pack_cohort
        for chunk in chunks:
            progs = [programs[i] for i in chunk]
            _dst_c, ann_c = _chunk_concat_starts(progs)
            m_ann = max(m_ann, tile_slices(ann_c, dblk, n_tiles, 0)[1])
            packed = None
            if fold_aligned:
                packed = pack_cohort(progs, blob)
                if not packed.contiguous or packed.dst.dtype != np.int32:
                    packed = None
            dst_c = packed.dst if packed is not None else _dst_c
            m_task = max(m_task, tile_slices(dst_c, dblk, n_tiles, k - 1)[1])
            if packed is not None:
                _ws, _wb, bp, _bs, _wlo, _blo, mw, mb = (
                    aligned_dense_inputs(
                        packed.dst, packed.src_biased, packed.total_res,
                        combined_len, dblk, n_tiles, k,
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


class ChunkHandle(NamedTuple):
    """In-flight device work for one chunk (see ``dispatch``/``collect``).

    ``kind``: ``"device"`` (vals/gpos/wins are async device arrays),
    ``"empty"`` (no window fits; collect returns empty rows), or ``"host"``
    (the chunk cannot run on device; collect returns None and the caller
    falls back to the host chain).
    """

    kind: str
    n_samples: int
    sample_starts: object   # i32[n_samples] chunk-coordinate segment starts
    hap1_lens: object       # per-sample haplotype-1 tape length
    packed: object          # [.., S, top, 8+k] u8 packed rows (device, async;
    #                         one buffer = ONE fetch round trip, _pack_rows)
    decode: object = None   # sharded engines only: per-shard lists of
    #                         (pair_idx, seg_start, hap1_len) decode tuples


class DeviceNeoantigenEngine:
    """Chunked device-resident executor+scorer.

    ``run_chunk(programs)`` returns per-sample candidate rows
    ``[(score, hap_no, hap_local_pos, peptide_bytes), ...]`` sorted by
    descending score, top ``top`` per sample -- the same rows the host-batched
    path (downstream/cohort.py) produces, with ~1000x less device->host
    traffic.

    ``dispatch``/``collect`` split that into an async launch and a blocking
    fetch so a multi-chunk driver can keep chunk N+1's dense+rank computing
    on device while chunk N's ``[S, top]`` rows are fetched and written --
    the analogue of the reference keeping every worker busy end-to-end
    (reference: src/parts/exec.rs:36-39) and of the FASTA executor's
    dispatch/collect (runtime/device_engine.py).
    """

    def __init__(self, blob: RefBlob, k: int, params=None, top: int = 200,
                 device=None):
        import jax

        self.blob = blob
        self.k = k
        self.top = top
        self.params = params if params is not None else init_params(k)
        self.device = device or jax.devices()[0]
        self._blob_dev = jax.device_put(blob.data, self.device)
        self._combined_key = None
        self._combined_dev = None
        self._combined_ref = None

    def _combined(self, packed, alt_bucket=None):
        import jax
        import jax.numpy as jnp

        if packed.alt_key is not None and packed.alt_key == self._combined_key:
            return self._combined_dev
        if alt_bucket is None:
            alt_bucket = pad_to_bucket(max(len(packed.alt), 1))
        alt = np.zeros(alt_bucket, dtype=np.uint8)
        alt[: len(packed.alt)] = packed.alt
        combined = jnp.concatenate(
            [self._blob_dev, jax.device_put(alt, self.device)]
        )
        if packed.alt_key is not None:
            self._combined_key = packed.alt_key
            self._combined_dev = combined
            self._combined_ref = packed.alt  # pin the id() key's object
        return combined

    def run_chunk(self, programs, buckets: Buckets = None):
        """Device-resident results for one pair-aligned chunk; returns
        ``{local_sample_idx: [(score, hap, hap_pos, peptide), ...]}`` or
        None when the chunk must fall back to the host path (malformed pack
        or non-tiling annotations).

        ``buckets`` pins the device shapes run-wide (see :class:`Buckets`);
        None sizes them for this chunk alone."""
        return self.collect(self.dispatch(programs, buckets=buckets))

    def dispatch(self, programs, buckets: Buckets = None) -> ChunkHandle:
        """Pack + launch one chunk WITHOUT blocking; pair with
        :meth:`collect`. The dense+rank dispatches are async, so the device
        computes this chunk while the caller fetches a previous one."""
        import jax

        packed = pack_cohort(programs, self.blob)
        n_samples = len(programs) // 2
        host = ChunkHandle("host", n_samples, None, None, None)
        if not packed.contiguous or packed.total_res == 0:
            return host
        if packed.dst.dtype != np.int32:
            # >2 GiB chunks escalate the pack to int64; the int32 delta
            # expansion would overflow -- chunk smaller or fall back
            return host
        ann_spans = _chunk_annotation_spans(programs, packed.spans)
        if ann_spans is None:
            return host
        ann_starts, ann_ends = ann_spans
        if self.k > packed.total_res:
            # no window can fit; skip building the [out, k] window stack
            return ChunkHandle("empty", n_samples, None, None, None)
        sample_starts = np.asarray(
            [packed.spans[2 * i][1] for i in range(n_samples)], np.int32
        )
        out_bucket = pad_to_bucket(packed.total_res)
        task_bucket = pad_to_bucket(len(packed.dst))
        ann_need = pad_to_bucket(max(len(ann_starts), 1))
        s_need = pad_to_bucket(n_samples)
        alt_need = pad_to_bucket(max(len(packed.alt), 1))
        if buckets is not None:
            out_bucket = max(out_bucket, buckets.out)
            task_bucket = max(task_bucket, buckets.tasks)
            ann_need = max(ann_need, buckets.ann)
            s_need = max(s_need, buckets.samples)
            alt_need = max(alt_need, buckets.alt)
        spb = count_spb(sample_starts, rank_blk(out_bucket))
        if buckets is not None:
            spb = max(spb, buckets.spb)
        combined = self._combined(packed, alt_bucket=alt_need)
        idx_dtype = packed.dst.dtype
        imax = np.iinfo(np.int32).max
        dst = np.full(task_bucket, imax, dtype=idx_dtype)
        dst[: len(packed.dst)] = packed.dst
        srcb = np.zeros(task_bucket, dtype=idx_dtype)
        srcb[: len(packed.src_biased)] = packed.src_biased
        # a task is alt-sourced iff pack_cohort biased its source past the
        # proteome blob (exactly the exe==1 tasks)
        exe = np.zeros(task_bucket, np.int8)
        exe[: len(packed.src_biased)] = (
            packed.src_biased >= len(self.blob.data)
        )
        ann_bucket = ann_need
        ann_s = np.full(ann_bucket, imax, np.int32)
        ann_s[: len(ann_starts)] = ann_starts
        ann_e = np.zeros(ann_bucket, np.int32)
        ann_e[: len(ann_ends)] = ann_ends
        s_bucket = s_need
        # padded entries scatter out of range and are dropped
        st = np.full(s_bucket, imax, np.int32)
        st[:n_samples] = sample_starts
        put = lambda a: jax.device_put(a, self.device)  # noqa: E731
        blk = dense_blk(out_bucket, self.params)
        n_tiles = out_bucket // blk
        tl, m_task = tile_slices(packed.dst, blk, n_tiles, self.k - 1)
        al, m_ann = tile_slices(ann_starts, blk, n_tiles, 0)
        m_task = min(task_bucket, max(
            pad_to_bucket(m_task), buckets.m_task if buckets else 1))
        m_ann = min(ann_bucket, max(
            pad_to_bucket(m_ann), buckets.m_ann if buckets else 1))
        c_bucket = min(out_bucket, max(
            pad_to_bucket(max(cand_bound(programs, self.k), 1)),
            buckets.cand if buckets else 1))
        total_res = np.int32(packed.total_res)
        if use_compact(self.params, self.k, out_bucket, c_bucket):
            # wide head: mask-only pass + compacted scoring + rank, fused
            # into ONE dispatch (_compact_core)
            rows_packed = _compact_fn(
                out_bucket, self.k, blk, m_task, m_ann, c_bucket, s_bucket,
                self.top,
            )(
                combined, put(dst), put(srcb), put(exe), put(ann_s),
                put(ann_e), put(st), self.params, total_res, put(tl),
                put(al),
            )
        elif use_aligned_dense(out_bucket, int(combined.shape[0])):
            # word-aligned execute inside the tiled dense pass: the word
            # program + its per-tile slice tables ride extra inputs
            ws, wb, bp, bs, wlo, blo, mw, mb = aligned_dense_inputs(
                packed.dst, packed.src_biased, packed.total_res,
                int(combined.shape[0]), blk, n_tiles, self.k,
            )
            m_w = min(task_bucket, max(
                pad_to_bucket(mw), buckets.m_w if buckets else 1))
            b_bucket = max(pad_to_bucket(max(len(bp), 1)),
                           buckets.bpos if buckets else 1)
            m_b = min(b_bucket, max(
                pad_to_bucket(mb), buckets.m_b if buckets else 1))
            ws_p = np.full(task_bucket, imax, np.int32)
            ws_p[: len(ws)] = ws
            wb_p = np.zeros(task_bucket, np.int32)
            wb_p[: len(wb)] = wb
            bp_p = np.full(b_bucket, imax, np.int32)
            bp_p[: len(bp)] = bp
            bs_p = np.zeros(b_bucket, np.int32)
            bs_p[: len(bs)] = bs
            tape, cand, scores = _dense_fn_aligned(
                out_bucket, self.k, blk, m_task, m_ann, m_w, m_b
            )(
                combined, put(dst), put(srcb), put(exe), put(ann_s),
                put(ann_e), self.params, total_res, put(tl), put(al),
                put(ws_p), put(wb_p), put(bp_p), put(bs_p), put(wlo),
                put(blo),
            )
            rows_packed = _rank_fn(
                out_bucket, self.k, s_bucket, self.top, spb
            )(tape, cand, scores, put(st))
        else:
            tape, cand, scores = _dense_fn(
                out_bucket, self.k, blk, m_task, m_ann
            )(
                combined, put(dst), put(srcb), put(exe), put(ann_s),
                put(ann_e), self.params, total_res, put(tl), put(al),
            )
            rows_packed = _rank_fn(
                out_bucket, self.k, s_bucket, self.top, spb
            )(tape, cand, scores, put(st))
        hap1_lens = [
            packed.spans[2 * i][2] - packed.spans[2 * i][1]
            for i in range(n_samples)
        ]
        return ChunkHandle(
            "device", n_samples, sample_starts, hap1_lens, rows_packed
        )

    def collect(self, handle: ChunkHandle):
        """Blocking fetch + row decode of a dispatched chunk; returns the
        ``run_chunk`` row dict, or None for a ``"host"`` handle (the caller
        runs the host fallback)."""
        if handle.kind == "host":
            return None
        if handle.kind == "empty":
            return {i: [] for i in range(handle.n_samples)}
        n_samples = handle.n_samples
        # the ONLY fetch: one packed [S, top, 8+k] buffer = one round trip
        vals, gpos, wins = _unpack_rows(np.asarray(handle.packed)[:n_samples])
        return {
            i: _decode_rows(
                vals[i], gpos[i], wins[i],
                int(handle.sample_starts[i]), int(handle.hap1_lens[i]),
            )
            for i in range(n_samples)
        }


def write_device_neoantigen_reports(outdir, proband_names, programs, blob,
                                    k: int, params=None, top: int = 200,
                                    chunk_res_bytes: int = 256 * 1024 * 1024,
                                    device=None, mesh=None):
    """End-to-end device-resident neoantigen reports for a cohort.

    Same TSV schema and ranking as the host-batched path
    (cohort.write_reports_from_candidates); chunks that cannot run on device
    (malformed pack, non-tiling annotations) fall back to host collection +
    the batched scorer so output coverage is never lost, and are counted.
    ``mesh`` switches to the dp-sharded multi-device chain
    (parallel/sharded_neoantigen.py). Returns ``(paths, host_chunks)``.
    """
    import os

    from ..pipeline import _chunk_indices

    if params is None:
        params = init_params(k)
    chunks = _chunk_indices(programs, chunk_res_bytes, pair_aligned=True)
    # one Buckets across all chunks => at most one compile per jitted
    # function per run, residual chunks included
    if mesh is not None:
        from ..parallel.sharded_neoantigen import (
            ShardedNeoantigenEngine,
            shard_buckets,
        )

        eng = ShardedNeoantigenEngine(blob, mesh, k, params=params, top=top)
        buckets = shard_buckets(programs, chunks, mesh.devices.size, k=k,
                                params=params, blob=blob)
    else:
        eng = DeviceNeoantigenEngine(blob, k, params=params, top=top,
                                     device=device)
        buckets = run_buckets(programs, chunks, k=k, params=params,
                              blob=blob)
    paths = []
    host_chunks = 0

    def write_rows(chunk, progs, rows):
        nonlocal host_chunks
        if rows is None:  # "host" handle: run the fallback chain
            host_chunks += 1
            rows = _host_chunk_rows(progs, blob, k, params, top)
        for local_i, sample_rows in rows.items():
            sample_idx = chunk[2 * local_i] // 2
            proband = proband_names[sample_idx]
            hap_pair = (programs[2 * sample_idx],
                        programs[2 * sample_idx + 1])
            path = os.path.join(outdir, f"{proband}.neoantigens.tsv")
            with open(path, "w") as fh:
                fh.write(
                    "peptide\thaplotype\ttranscript\tprotein_start\tscore\n"
                )
                for sc, hap, hpos, pep in sample_rows:
                    prog = hap_pair[hap - 1]
                    name, span_start = _span_of(prog.annotations, hpos)
                    rel = hpos - span_start
                    fh.write(
                        f"{pep.decode('ascii')}\t{hap}\t{name}\t{rel}\t"
                        f"{sc:.6f}\n"
                    )
            paths.append(path)

    # double-buffered drive: dispatch chunk N+1 BEFORE collecting chunk N,
    # so the device computes the next chunk while the previous chunk's
    # [S, top] rows are fetched and its TSVs hit disk
    pending = None
    for chunk in chunks:
        progs = [programs[i] for i in chunk]
        handle = eng.dispatch(progs, buckets=buckets)
        if pending is not None:
            write_rows(pending[0], pending[1], eng.collect(pending[2]))
        pending = (chunk, progs, handle)
    if pending is not None:
        write_rows(pending[0], pending[1], eng.collect(pending[2]))
    return NeoReports(paths, host_chunks)


class NeoReports(NamedTuple):
    """What :func:`write_device_neoantigen_reports` wrote."""

    paths: list       # one TSV per sample
    host_chunks: int  # chunks that ran the host fallback chain


def _host_chunk_rows(progs, blob, k, params, top):
    """Host-path fallback for one chunk: oracle execution + host candidate
    collection + the batched scorer; same row tuples as run_chunk."""
    from ..runtime import cpu_engine
    from .cohort import collect_candidates, score_cohort

    tapes = [cpu_engine.execute_tasks(p, blob) for p in progs]
    windows, sample_ids, haps, starts = collect_candidates(progs, tapes, k)
    scores = score_cohort(windows, params)
    out = {i: [] for i in range(len(progs) // 2)}
    for i in range(len(progs) // 2):
        sel = np.nonzero(sample_ids == i)[0]
        order = sel[np.argsort(-scores[sel], kind="stable")][:top]
        out[i] = [
            (
                float(scores[j]),
                int(haps[j]),
                int(starts[j]),
                bytes(windows[j]),
            )
            for j in order
        ]
    return out

"""Cohort-batched neoantigen scoring: one device batch across all samples.

The per-sample report path (``report.py``) scores each sample's candidate
windows on host. On the device the production shape is one batch: every
sample's mutation-overlapping k-mers concatenate into a single [M, k] tensor,
pad to a power-of-two bucket (bounded recompiles, static shapes), and run
through the bf16 scoring head in one jitted call -- matrix units want large
batched matmuls, not per-sample slivers (reference analogue: the per-sample
loop at automation_scripts level; there is no batched scorer to mirror, this
is net-new capability).

Candidate *collection* stays on host (it reads the task program's alt spans,
which are host-resident), so memory is bounded by the number of candidate
windows (k bytes each), never by the cohort's tapes.
"""
from __future__ import annotations

import functools

import numpy as np

from .peptides import alt_byte_mask, valid_window_starts
from .report import _host_candidates, _span_of


def _collect_candidates_fast(prog, tape, k: int):
    """Candidate collection for one haplotype: the C++ single pass when the
    native module is loaded (array-backed annotations required), else the
    numpy oracle (report._host_candidates). Tests pin array equality, so
    either path feeds the batched scorer identically.
    """
    from ..native_bridge import load_native

    native = load_native()
    ann = prog.annotations
    if (
        native is not None
        and hasattr(native, "collect_candidates")
        and hasattr(ann, "starts")
        and isinstance(prog.alt, (bytes, bytearray))
    ):
        wins, starts = native.collect_candidates(
            np.ascontiguousarray(prog.exe, np.uint8),
            np.ascontiguousarray(prog.src, np.int64),
            np.ascontiguousarray(prog.length, np.int64),
            np.ascontiguousarray(prog.dst, np.int64),
            prog.alt,
            np.ascontiguousarray(ann.starts, np.int64),
            np.ascontiguousarray(ann.ends, np.int64),
            np.ascontiguousarray(tape, np.uint8),
            int(prog.res_len),
            int(k),
        )
        w = np.frombuffer(wins, np.uint8).reshape(-1, k)
        s = np.frombuffer(starts, np.int64)
        return w, s
    return _host_candidates(prog, tape, k)


class CohortCandidates:
    """Incremental candidate accumulator.

    The pipeline's device path streams execution in chunks and drops each
    tape after its sample is written; candidates (k bytes per window) are the
    only thing retained, so cohort memory stays bounded by hit count, not
    tape bytes.
    """

    def __init__(self, k: int):
        import threading

        self.k = k
        self._wins, self._samples, self._haps, self._starts = [], [], [], []
        # the pipeline's MT writer fan-out calls add() from worker threads;
        # the four parallel lists must stay index-aligned
        self._lock = threading.Lock()

    def add(self, sample_idx: int, hap_no: int, prog, tape):
        w, s = _collect_candidates_fast(prog, np.asarray(tape), self.k)
        if w.shape[0] == 0:
            return
        with self._lock:
            self._wins.append(w)
            self._starts.append(s)
            self._samples.append(np.full(w.shape[0], sample_idx, np.int32))
            self._haps.append(np.full(w.shape[0], hap_no, np.int8))

    def arrays(self):
        if not self._wins:
            return (np.empty((0, self.k), np.uint8), np.empty(0, np.int32),
                    np.empty(0, np.int8), np.empty(0, np.int64))
        return (np.concatenate(self._wins), np.concatenate(self._samples),
                np.concatenate(self._haps), np.concatenate(self._starts))


def collect_candidates(progs, tapes, k: int):
    """Gather every (sample, haplotype) pair's mutation-overlapping k-mers.

    ``progs``/``tapes``: flat lists, 2 entries per sample (hap1, hap2), as
    produced by the pipeline. Returns ``(windows u8[M, k], sample i32[M],
    hap i8[M], starts i64[M])``; M = 0 gives empty arrays of the right shape.
    """
    acc = CohortCandidates(k)
    for idx, (prog, tape) in enumerate(zip(progs, tapes)):
        acc.add(idx // 2, idx % 2 + 1, prog, tape)
    return acc.arrays()


def _bucket(m: int, floor: int = 1024) -> int:
    b = floor
    while b < m:
        b <<= 1
    return b


@functools.lru_cache(maxsize=16)
def _jitted_scorer(k: int, bucket: int, blk: int):
    import jax

    from ..utils.jaxcache import enable_persistent_cache
    from .scoring import score_windows

    enable_persistent_cache()

    if bucket <= blk:
        return jax.jit(score_windows)

    @jax.jit
    def run(padded, params):
        # one dispatch, lax.map over fixed blocks: bounds the one-hot /
        # hidden activations (a 4M-row bucket at a 512-wide deep head would
        # otherwise materialize ~8 GB of fp32 hidden state per layer)
        return jax.lax.map(
            lambda w: score_windows(w, params),
            padded.reshape(bucket // blk, blk, k),
        ).reshape(bucket)

    return run


def score_cohort(windows: np.ndarray, params: dict) -> np.ndarray:
    """Score [M, k] windows in one bucketed device batch; returns f32[M].

    Rows are independent through every layer (one-hot -> embedding einsum ->
    dense stack), so bucket padding cannot perturb live rows; results are
    bit-identical to scoring the exact-size batch.
    """
    from .device_resident import dense_blk

    m, k = windows.shape
    if m == 0:
        return np.zeros(0, np.float32)
    bucket = _bucket(m)
    padded = np.zeros((bucket, k), dtype=np.uint8)
    padded[:m] = windows
    run = _jitted_scorer(k, bucket, dense_blk(bucket, params))
    return np.asarray(run(padded, params))[:m]


def write_reports_from_candidates(outdir, proband_names, progs, candidates,
                                  k: int, params=None, top: int = 200):
    """Score accumulated candidates in one device batch and write the
    per-sample TSVs (same schema as ``report.write_neoantigen_report``)."""
    import os

    from .scoring import init_params

    if params is None:
        params = init_params(k)
    windows, sample_ids, haps, starts = candidates
    scores = score_cohort(windows, params)
    # ONE stable lexsort groups rows by (sample asc, score desc); the old
    # per-sample nonzero scan was O(samples x candidates) and dominated
    # north-star-scale hybrid runs (2,504 samples x ~50M candidates).
    # Stability preserves the original order within score ties, exactly
    # like the per-sample stable argsort it replaces.
    grouped = np.lexsort((-scores, sample_ids))
    sorted_ids = sample_ids[grouped]
    seg = np.searchsorted(sorted_ids, np.arange(len(proband_names) + 1))
    paths = []
    for i, proband in enumerate(proband_names):
        order = grouped[seg[i]:seg[i + 1]][:top]
        path = os.path.join(outdir, f"{proband}.neoantigens.tsv")
        with open(path, "w") as fh:
            fh.write(
                "peptide\thaplotype\ttranscript\tprotein_start\tscore\n"
            )
            for j in order:
                prog = progs[2 * i + (int(haps[j]) - 1)]
                s = int(starts[j])
                name, span_start = _span_of(prog.annotations, s)
                rel = s - span_start
                fh.write(
                    f"{bytes(windows[j]).decode('ascii')}\t{haps[j]}\t"
                    f"{name}\t{rel}\t{scores[j]:.6f}\n"
                )
        paths.append(path)
    return paths


def write_cohort_neoantigen_reports(outdir, proband_names, progs, tapes,
                                    k: int, params=None, top: int = 200):
    """Batched twin of ``report.write_neoantigen_report`` over a cohort.

    Same TSV schema and per-sample top-``top`` selection; the only difference
    is where the scores are computed (one device batch vs per-sample host
    math, bf16 device vs fp32 host).
    """
    return write_reports_from_candidates(
        outdir, proband_names, progs, collect_candidates(progs, tapes, k),
        k, params=params, top=top,
    )

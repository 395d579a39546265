"""Device execution engine.

The reference's (stubbed) accelerator runs one GPU thread per Task row
(reference: gir.rs:283-299 SoA export, README.md:72). This build formulates
it differently: the contiguity invariant means the result tape is a
*partition* of output positions by task, so the whole cohort executes as

    t     = searchsorted(task_dst_starts, j) - 1      # task covering byte j
    out[j] = combined[src_biased[t] + j - dst[t]]     # one gather

-- vectorized ops over static-shaped arrays, jitted once per shape bucket.
``combined`` is the device-resident reference-proteome blob with the cohort
alt tape appended; the blob is uploaded once per run and shared by every
chunk, sample and haplotype.

The covering-task expansion is NOT a per-byte binary search: XLA lowers a
per-byte ``searchsorted`` to log2(n) serialized gather rounds. So the
per-byte source index is produced by scattering first-difference deltas of
``src_biased - dst`` at task starts and cumsum-ing -- identical to
``vals[searchsorted(dst, j, 'right') - 1]`` for sorted starts (coincident
zero-length-task starts telescope to the last task, same tie rule). This
choice, like the word-aligned form below, was measured on another
accelerator and is not yet measured on the H100.

No data-dependent control flow, no raggedness on device: chunk totals are
padded to power-of-two buckets and sliced exactly on the host.

**Word-aligned executor (the default).** The compiler owns task boundaries,
so the pack can be re-expressed at word granularity on the host: every task
splits into word-uniform middle words plus an explicit boundary-byte list
(``build_aligned_program``). The device kernel is then fix-up-free --
word-granularity delta expansion (4x fewer cumsum lanes), two aligned u32
loads + shift-combine per output word (4x fewer gather lanes than the
per-byte kernel), and one small boundary byte gather + scatter (~5% of
output bytes at the production mean task length); output is byte-identical.
The per-byte ``delta`` kernel remains as the fallback
(``VCF2PROT_ALIGNED_EXEC=0``, and for >2 GiB int64 packs). Alignment is
decided at compile time, not per lane at run time (reference analogue:
task.rs:38-50's copy_from_slice is word-copy via memcpy).
"""
from __future__ import annotations

import numpy as np

from ..compiler.haplotype import RefBlob
from . import cpu_engine
from .kernels import check_packed
from .pack import (
    PackedCohort,
    pack_cohort,
    pad_to_bucket,
    program_is_contiguous,
)

_EXECUTE_CACHE = {}


def build_aligned_program(dst, src_biased, total_res: int,
                          combined_len: int, wbytes: int = 4):
    """Host-side compile pass for the word-aligned executor; dispatches to
    the native one-pass builder for int32 packs (the numpy body below is
    the oracle -- tests pin array equality), which avoids the word-length
    cover/cumsum temporaries that cost ~2 s per 128 MB chunk in numpy.

    Splits the contiguous task stream into (a) word-uniform MIDDLE words --
    output words fully covered by one task whose word loads stay in bounds
    -- expressed as a word-granularity delta program (``wstart`` word index
    of each task's first middle word, ``wbase`` = src - dst), and (b) an
    explicit BOUNDARY byte list (positions + sources) for every byte of a
    non-uniform word. Tasks whose source span ends within 8 bytes of the
    combined tape are demoted entirely to boundary bytes so the kernel's
    two-word loads never read garbage that survives into output.

    Returns ``(wstart i32[n], wbase i32[n], bpos i64[b], bsrc i64[b])``
    (unpadded; the caller buckets them). ``wbytes`` is the word width
    (production uses 4; the kernel-roofline shoot-out also measures 8).
    """
    if wbytes == 4 and dst.dtype == np.int32 and src_biased.dtype == np.int32:
        from ..native_bridge import load_native

        native = load_native()
        if native is not None and hasattr(native, "build_aligned_program"):
            ws_b, wb_b, bp_b, bs_b = native.build_aligned_program(
                np.ascontiguousarray(dst), np.ascontiguousarray(src_biased),
                int(total_res), int(combined_len),
            )
            return (
                np.frombuffer(ws_b, np.int32),
                np.frombuffer(wb_b, np.int32),
                np.frombuffer(bp_b, np.int32),
                np.frombuffer(bs_b, np.int32),
            )
    d = dst.astype(np.int64)
    s = src_biased.astype(np.int64)
    ends = np.append(d[1:], total_res)
    lens = ends - d
    w_first = (d + wbytes - 1) // wbytes
    w_last = ends // wbytes  # exclusive
    safe = (s + lens) <= (combined_len - 2 * wbytes)
    has_mid = (w_last > w_first) & safe
    n_words = (total_res + wbytes - 1) // wbytes
    cover = np.zeros(n_words + 1, np.int32)
    np.add.at(cover, w_first[has_mid], 1)
    np.add.at(cover, w_last[has_mid], -1)
    uniform = np.cumsum(cover[:-1]) > 0
    bwords = np.nonzero(~uniform)[0]
    bpos = (bwords[:, None] * wbytes
            + np.arange(wbytes)[None, :]).reshape(-1)
    bpos = bpos[bpos < total_res]
    t = np.searchsorted(d, bpos, side="right") - 1
    bsrc = s[t] + bpos - d[t]
    return (w_first.astype(np.int32), (s - d).astype(np.int32), bpos, bsrc)


def aligned_execute_body(combined, wstart, wbase, bpos, bsrc,
                         out_size: int):
    """Pure-jax body of the word-aligned executor; shared by the
    single-device jit (:func:`_get_aligned_jitted`) and the dp-sharded
    per-shard program (parallel/sharded.py). Padding conventions:
    ``wstart`` pads to iinfo.max (dropped scatter), ``bpos`` pads past the
    output (dropped set), ``bsrc`` is clipped here."""
    import jax
    import jax.numpy as jnp

    n_words = out_size // 4
    cw = jax.lax.bitcast_convert_type(
        combined[: (combined.shape[0] // 4) * 4].reshape(-1, 4),
        jnp.uint32,
    ).reshape(-1)
    delta = wbase - jnp.concatenate(
        [jnp.zeros(1, wbase.dtype), wbase[:-1]]
    )
    acc = jnp.zeros(n_words, wbase.dtype).at[wstart].add(
        delta, mode="drop"
    )
    base_w = jnp.cumsum(acc)
    jw = jnp.arange(n_words, dtype=jnp.int32) * 4
    g = jnp.clip(base_w + jw, 0, combined.shape[0] - 8)
    gi = g >> 2
    w0 = cw[gi]
    w1 = cw[gi + 1]
    sh = ((g & 3) * 8).astype(jnp.uint32)
    words = jnp.where(sh == 0, w0, (w0 >> sh) | (w1 << (32 - sh)))
    out = jax.lax.bitcast_convert_type(
        words[:, None], jnp.uint8
    ).reshape(-1)
    bvals = jnp.take(combined, jnp.clip(bsrc, 0, combined.shape[0] - 1))
    return out.at[bpos].set(bvals, mode="drop")


def use_aligned_exec(idx_dtype, out_bucket: int,
                     combined_len: int = None) -> bool:
    """Single gate for the word-aligned executor, shared by the
    single-device and dp-sharded engines so the policy cannot drift:
    int32 packs only, above the tiny-tape floor, below 2^30 lanes (the
    int32 pad sentinel must stay out of range), a combined blob+alt
    buffer of >= 2 words (the body gathers word pairs, so its clip bound
    ``combined_len - 8`` must stay non-negative), env opt-out honored."""
    import os

    return (
        os.environ.get("VCF2PROT_ALIGNED_EXEC", "1") != "0"
        and idx_dtype == np.int32
        and 1024 <= out_bucket <= (1 << 30)
        and (combined_len is None or combined_len >= 8)
    )


def pad_aligned_program(wstart, wbase, bpos, bsrc, task_bucket: int,
                        out_bucket: int, b_bucket: int):
    """Bucket-pad one aligned program per the body's padding conventions.
    The boundary-pad sentinel is int32 max, out of range of any gated
    out_bucket (use_aligned_exec caps it at 2^30), so padded scatter slots
    always drop."""
    ws = np.full(task_bucket, np.iinfo(np.int32).max, np.int32)
    ws[: len(wstart)] = wstart
    wb = np.zeros(task_bucket, np.int32)
    wb[: len(wbase)] = wbase
    bp = np.full(b_bucket, np.iinfo(np.int32).max, np.int32)  # dropped
    bp[: len(bpos)] = bpos
    bs = np.zeros(b_bucket, np.int32)
    bs[: len(bsrc)] = bsrc
    return ws, wb, bp, bs


def _get_aligned_jitted():
    """Jitted word-aligned executor factory (see build_aligned_program);
    jit specializes on the padded (task, boundary) argument shapes."""
    import jax

    if "aligned" in _EXECUTE_CACHE:
        return _EXECUTE_CACHE["aligned"]

    def build(out_size: int):
        @jax.jit
        def run(combined, wstart, wbase, bpos, bsrc):
            return aligned_execute_body(
                combined, wstart, wbase, bpos, bsrc, out_size
            )

        return run

    _EXECUTE_CACHE["aligned"] = build
    return build


def _get_jitted():
    """Build the jitted-executor factory lazily so importing this module does
    not initialize a JAX backend."""
    import jax
    import jax.numpy as jnp

    if "fn" in _EXECUTE_CACHE:
        return _EXECUTE_CACHE["fn"]

    def build(out_size: int):
        @jax.jit
        def run(combined, dst, src_biased):
            v = src_biased - dst
            delta = v - jnp.concatenate([jnp.zeros(1, v.dtype), v[:-1]])
            # bucket-padding tasks carry dst = iinfo.max and are dropped
            acc = jnp.zeros(out_size, v.dtype).at[dst].add(delta, mode="drop")
            base = jnp.cumsum(acc)
            j = jnp.arange(out_size, dtype=v.dtype)
            gidx = jnp.clip(base + j, 0, combined.shape[0] - 1)
            return jnp.take(combined, gidx)

        return run

    _EXECUTE_CACHE["fn"] = build
    return build



class DeviceEngine:
    """Device executor for cohorts of haplotype programs.

    Upload the proteome blob once; then ``execute`` arbitrary cohort chunks.
    Falls back to the serial host engine for (malformed) non-contiguous
    programs so behavior degrades to the oracle rather than mis-executing.
    """

    def __init__(self, blob: RefBlob, device=None, validate_on_device=False):
        import jax
        import jax.numpy as jnp

        from ..utils.jaxcache import enable_persistent_cache

        enable_persistent_cache()

        self._jnp = jnp
        self._jax = jax
        self.blob = blob
        self.device = device or jax.devices()[0]
        self._blob_dev = jax.device_put(blob.data, self.device)
        self._run_cache = {}
        # shared-alt-pool runs upload combined = blob || pool once and reuse
        # it for every chunk (keyed on the pool object identity)
        self._combined_key = None
        self._combined_dev = None
        self.validate = validate_on_device

    def _runner(self, out_size: int):
        if out_size not in self._run_cache:
            self._run_cache[out_size] = _get_jitted()(out_size)
        return self._run_cache[out_size]

    def execute(self, programs) -> list:
        """Execute haplotype programs; returns one uint8 array per program."""
        return self.collect(self.dispatch(programs))

    def dispatch(self, programs):
        """Pack + launch a chunk without blocking; pair with :meth:`collect`.

        Returns an opaque handle. Device work proceeds asynchronously, so a
        caller can keep one chunk in flight while fetching and writing the
        previous one.
        """
        packed = pack_cohort(programs, self.blob)
        if self.validate:
            # before any host-side isolation of malformed programs
            check_packed(packed, len(self.blob.data), self.device)
        good_mask = None
        if not packed.contiguous:
            # isolate the offending program(s): repack only the contiguous
            # ones for the device and leave the rest to the host oracle,
            # instead of de-accelerating the whole chunk
            good_mask = [program_is_contiguous(p) for p in programs]
            good = [p for p, g in zip(programs, good_mask) if g]
            if not good:
                return (packed, None, programs, None)
            packed = pack_cohort(good, self.blob)
            if not packed.contiguous:  # cross-program corruption: full oracle
                return (packed, None, programs, None)
        if packed.total_res == 0:
            return (packed, None, programs, good_mask)
        return (packed, self._launch(packed), programs, good_mask)

    def collect(self, handle) -> list:
        packed, out_dev, programs, good_mask = handle
        if good_mask is None and out_dev is None and packed.total_res > 0:
            # malformed beyond isolation: defer to the host oracle per program
            return [cpu_engine.execute_tasks(p, self.blob) for p in programs]
        if out_dev is None:
            dev_outs = iter(
                np.empty(0, dtype=np.uint8) for _ in packed.spans
            )
        else:
            out = np.asarray(out_dev[: packed.total_res])
            dev_outs = iter(
                out[start:end] for (_, start, end) in packed.spans
            )
        if good_mask is None:
            return list(dev_outs)
        return [
            next(dev_outs) if g else cpu_engine.execute_tasks(p, self.blob)
            for p, g in zip(programs, good_mask)
        ]

    def _launch(self, packed: PackedCohort):
        """Upload + dispatch one packed chunk; returns the device array."""
        jax, jnp = self._jax, self._jnp
        n_tasks = len(packed.dst)
        idx_dtype = packed.dst.dtype
        task_bucket = pad_to_bucket(n_tasks)
        out_bucket = pad_to_bucket(packed.total_res)
        if packed.alt_key is not None and packed.alt_key == self._combined_key:
            combined = self._combined_dev
        else:
            alt_bucket = pad_to_bucket(max(len(packed.alt), 1))
            alt = np.zeros(alt_bucket, dtype=np.uint8)
            alt[: len(packed.alt)] = packed.alt
            combined = jnp.concatenate(
                [self._blob_dev, jax.device_put(alt, self.device)]
            )
            if packed.alt_key is not None:
                self._combined_key = packed.alt_key
                self._combined_dev = combined
                # keep the pool buffer alive so the id() key cannot be reused
                # by a different object while this cache entry exists
                self._combined_ref = packed.alt
        if use_aligned_exec(idx_dtype, out_bucket, int(combined.shape[0])):
            wstart, wbase, bpos, bsrc = build_aligned_program(
                packed.dst, packed.src_biased, packed.total_res,
                int(combined.shape[0]),
            )
            ws, wb, bp, bs = pad_aligned_program(
                wstart, wbase, bpos, bsrc, task_bucket, out_bucket,
                pad_to_bucket(max(len(bpos), 1)),
            )
            key = ("aligned", out_bucket)
            if key not in self._run_cache:
                self._run_cache[key] = _get_aligned_jitted()(out_bucket)
            run = self._run_cache[key]
            return run(
                combined,
                jax.device_put(ws, self.device),
                jax.device_put(wb, self.device),
                jax.device_put(bp, self.device),
                jax.device_put(bs, self.device),
            )
        # per-byte delta fallback: pad task arrays (pad tasks start past the
        # real tape end so the covering expansion never selects them)
        dst = np.full(task_bucket, np.iinfo(idx_dtype).max, dtype=idx_dtype)
        dst[:n_tasks] = packed.dst
        srcb = np.zeros(task_bucket, dtype=idx_dtype)
        srcb[:n_tasks] = packed.src_biased
        run = self._runner(out_bucket)
        # collect slices on the device, so the fetch copies live bytes
        # only, not bucket padding
        return run(
            combined,
            jax.device_put(dst, self.device),
            jax.device_put(srcb, self.device),
        )

#!/usr/bin/env python
"""Smoke run of vcf2prot-tpu on an NVIDIA GPU, through the user entry points.

    python chip_smoke.py               # one card: phases 1-6
    python chip_smoke.py --four-cards  # four cards: phases 2 and 4 through
                                       # the dp-sharded engines

One process drives the card(s); every run goes through ``cli.main`` or
``run_pipeline`` in this process, never a subprocess that would open the card
again. Cohorts come from ``tests/genvcf.py`` with a fixed seed and are cached
under ``<repo>/.smoke_cache``.

Phases (each prints one line; any failure exits non-zero and prints no
result):

1. env        -- JAX's default device must be a GPU; device_kind, the card's
                 name and power limit, the JAX version, the native tier.
2. fasta-chromosome -- 128 samples x 1,200 transcripts (the top of the
                 reference's chromosome-1 sweep): ``-g gpu`` byte-identical,
                 file by file, to ``-g mt`` and to the Python oracle
                 (``-g st``, cpu_engine.execute_tasks).
3. fasta-proteome -- 64 samples x 20,000 transcripts (a whole proteome, one
                 256 MB chunk), same checks.
4. neoantigen -- ``-g gpu --neoantigen_only --neoantigen_k 9
                 --neoantigen_top 200`` on the phase-2 cohort with the scaffold head (dense path)
                 and a 512x3 head (compacted path), against the numpy fp32
                 oracle (``-g st``: report._host_scores on cpu_engine tapes)
                 and the on-device batch scorer (``-g mt
                 --neoantigen_device``); no chunk may fall back to the host.
5. debug-gpu  -- ``DEBUG_GPU=1 -g gpu`` passes on the phase-2 cohort, and a
                 program with one corrupted ``dst`` raises.
6. kernels    -- readings, not claims: per-call device time,
                 ``memory_analysis()`` and XLA's cost-model bytes (with the
                 HBM-peak share they imply) of the aligned and per-byte
                 executors at the phase-3 chunk and of the dense pass and
                 rank at the phase-4 chunk.

Tolerances:

* FASTA: exact bytes -- the executor is an integer gather and copy.
* neoantigen vs the numpy fp32 oracle: |d| <= 2e-2 * max(1, |s|) -- the
  device rounds weights and activations to bf16 (8-bit mantissa) over sums
  of up to 288 terms.
* neoantigen vs the on-device batch scorer: |d| <= 1e-3 * max(1, |s|) --
  the same bf16 math with another accumulation order.
* each sample's top-200 set of (haplotype, transcript, position, peptide)
  must match; only rows whose score lies within twice the tolerance of the
  oracle's 200th score may differ (the two sides' errors add at the cut).
  Order may differ only among rows within the tolerance of each other.
"""
import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".smoke_cache")
SEED = 20260817
K = 9
TOP = 200
CHROMOSOME = (128, 1200)
PROTEOME = (64, 20000)
FP32_RTOL = 2e-2
BATCHED_RTOL = 1e-3
REPS = 5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] ok {parts}", flush=True)


# ---------------------------------------------------------------- helpers


def require_gpu_platform(jax, count):
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX's default device is {devs[0].platform!r}, not a GPU")
    check(len(devs) == count, f"expected {count} GPU(s), JAX sees {len(devs)}")
    return devs[0]


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cohort(n_samples, n_txp):
    """Cached (vcf, fasta) paths of a seeded synthetic cohort."""
    from genvcf import random_cohort, write_fasta, write_synthetic_vcf

    os.makedirs(CACHE, exist_ok=True)
    stem = os.path.join(CACHE, f"s{SEED}_{n_samples}x{n_txp}")
    vcf, fasta = stem + ".vcf", stem + ".fasta"
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        ref, samples = random_cohort(
            seed=SEED, n_samples=n_samples, n_transcripts=n_txp
        )
        write_synthetic_vcf(vcf + ".tmp", ref, samples)
        write_fasta(fasta + ".tmp", ref)
        os.replace(vcf + ".tmp", vcf)
        os.replace(fasta + ".tmp", fasta)
    return vcf, fasta


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its
    monitoring events."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self, jax):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.total += duration


def fresh_dir(path):
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def run_cli(argv, clock):
    from vcf2prot_tpu.cli import main

    c0 = clock.total
    t0 = time.perf_counter()
    rc = main(argv)
    check(rc == 0, f"cli {argv} returned {rc}")
    return time.perf_counter() - t0, clock.total - c0


def same_dirs(a, b, what):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    check(fa == fb, f"{what}: file sets differ ({len(fa)} vs {len(fb)})")
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            check(x.read() == y.read(), f"{what}: {f} differs")
    return len(fa)


def dir_mb(path):
    return sum(
        os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
    ) / 1e6


def device_ms(fn, args):
    """Median warm wall time of ``fn(*args)`` ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def compiled_stats(fn, args):
    """``memory_analysis()`` of one compiled jit, and the HBM bytes XLA's
    cost model charges it (``cost_analysis()['bytes accessed']``)."""
    c = fn.lower(*args).compile()
    m = c.memory_analysis()
    mem = (f"arg={m.argument_size_in_bytes / 1e6:.1f}MB,"
           f"out={m.output_size_in_bytes / 1e6:.1f}MB,"
           f"temp={m.temp_size_in_bytes / 1e6:.1f}MB")
    return mem, c.cost_analysis()["bytes accessed"]


@contextlib.contextmanager
def recording_jits(store):
    """Record the jitted device-resident programs and their last arguments
    while the pipeline runs, so phase 6 can time each one alone."""
    from vcf2prot_tpu.downstream import device_resident as dr

    names = ("_dense_fn", "_dense_fn_aligned", "_rank_fn", "_compact_fn")
    orig = {n: getattr(dr, n) for n in names}

    def wrap(name, factory):
        def make(*a, **kw):
            fn = factory(*a, **kw)

            def call(*args):
                store[name] = (fn, args)
                return fn(*args)

            return call
        return make

    for n in names:
        setattr(dr, n, wrap(n, orig[n]))
    try:
        yield store
    finally:
        for n in names:
            setattr(dr, n, orig[n])


@contextlib.contextmanager
def recording_results(store):
    """Keep the ``PipelineResult`` of every ``cli.main`` call in the block
    (the CLI itself returns only an exit code)."""
    from vcf2prot_tpu import cli

    orig = cli.run_pipeline

    def call(cfg):
        store.append(orig(cfg))
        return store[-1]

    cli.run_pipeline = call
    try:
        yield store
    finally:
        cli.run_pipeline = orig


def read_rows(path):
    rows = []
    with open(path) as fh:
        header = fh.readline()
        check(header.startswith("peptide\t"), f"{path}: bad header")
        for line in fh:
            pep, hap, txp, start, score = line.rstrip("\n").split("\t")
            rows.append(((hap, txp, start, pep), float(score)))
    return rows


def compare_rows(dev_dir, ref_dir, names, rtol, what):
    """Top-TOP rows of every sample against an oracle under ``rtol``;
    returns (max |d| / max(1, |s|), rows allowed to differ at the cut)."""
    def tol(s):
        return rtol * max(1.0, abs(s))

    worst = 0.0
    at_cut = 0
    for name in names:
        f = f"{name}.neoantigens.tsv"
        dev = read_rows(os.path.join(dev_dir, f))
        ref = read_rows(os.path.join(ref_dir, f))
        check(len(dev) == len(ref),
              f"{what} {name}: {len(dev)} rows vs {len(ref)}")
        for rows in (dev, ref):
            for (_k1, s1), (_k2, s2) in zip(rows, rows[1:]):
                check(s2 <= s1 + tol(s1), f"{what} {name}: rows not ranked")
        dmap, rmap = dict(dev), dict(ref)
        for key in dmap.keys() & rmap.keys():
            d = abs(dmap[key] - rmap[key])
            check(d <= tol(rmap[key]),
                  f"{what} {name} {key}: {dmap[key]} vs {rmap[key]}")
            worst = max(worst, d / max(1.0, abs(rmap[key])))
        extra = dmap.keys() ^ rmap.keys()
        if extra:
            check(len(ref) == TOP,
                  f"{what} {name}: row sets differ below the top-{TOP} cut")
            cut = ref[-1][1]
            for key in extra:
                s = dmap.get(key, rmap.get(key))
                check(abs(s - cut) <= 2 * tol(cut),
                      f"{what} {name} {key}: score {s} is not at the cut "
                      f"{cut}")
            at_cut += len(extra)
    return worst, at_cut


# ----------------------------------------------------------------- phases


def phase_env(jax, count):
    from vcf2prot_tpu.native_bridge import load_native

    dev = require_gpu_platform(jax, count)
    card = card_line()
    native = load_native()
    check(native is not None, "the native tier did not build or load")
    phase("env", platform=dev.platform, device_kind=repr(dev.device_kind),
          count=len(jax.devices()), jax=jax.__version__, native="loaded")
    print(f"card: {card}", flush=True)
    return dev


def phase_fasta(name, size, work, clock):
    vcf, fasta = cohort(*size)
    base = ["-f", vcf, "-r", fasta]
    out = {e: os.path.join(work, f"{name}_{e}") for e in ("gpu", "mt", "st")}
    cold, cold_c = run_cli(base + ["-o", fresh_dir(out["gpu"]), "-g", "gpu"],
                           clock)
    warm, warm_c = run_cli(base + ["-o", fresh_dir(out["gpu"]), "-g", "gpu"],
                           clock)
    mt, _ = run_cli(base + ["-o", fresh_dir(out["mt"]), "-g", "mt"], clock)
    st, _ = run_cli(base + ["-o", fresh_dir(out["st"]), "-g", "st"], clock)
    n = same_dirs(out["gpu"], out["mt"], f"{name} gpu vs mt")
    same_dirs(out["gpu"], out["st"], f"{name} gpu vs st oracle")
    import jax

    phase(name, samples=size[0], transcripts=size[1], files=n,
          output_mb=f"{dir_mb(out['gpu']):.1f}", devices=jax.device_count(),
          cold_s=f"{cold:.3f}", warm_s=f"{warm:.3f}",
          compile_s=f"{cold_c:.3f}", warm_compile_s=f"{warm_c:.3f}",
          mt_s=f"{mt:.3f}", st_s=f"{st:.3f}", match="bytes(gpu=mt=st)")
    return out["gpu"]


def phase_neoantigen(work, clock, jits):
    import numpy as np

    from vcf2prot_tpu.downstream.scoring import init_params

    vcf, fasta = cohort(*CHROMOSOME)
    wide = os.path.join(work, "head_512x3.npz")
    np.savez(wide, **init_params(K, hidden=512, depth=3))
    names = None
    for head, params in (("scaffold", ""), ("512x3", wide)):
        out = {e: os.path.join(work, f"neo_{head}_{e}")
               for e in ("gpu", "st", "mt")}
        base = ["-f", vcf, "-r", fasta, "--neoantigen_k", str(K),
                "--neoantigen_top", str(TOP), "--neoantigen_only"]
        if params:
            base += ["--neoantigen_params", params]
        times = []
        for _ in range(2):  # cold, warm
            results = []
            with recording_jits({}) as seen, recording_results(results):
                times.append(run_cli(
                    base + ["-o", fresh_dir(out["gpu"]), "-g", "gpu"], clock
                ))
            res = results[-1]
            check(res.neo_host_chunks == 0,
                  f"neoantigen[{head}]: {res.neo_host_chunks} chunks fell "
                  "back to the host")
        jits[head] = dict(seen)
        run_cli(base + ["-o", fresh_dir(out["st"]), "-g", "st"], clock)
        run_cli(base + ["-o", fresh_dir(out["mt"]), "-g", "mt",
                        "--neoantigen_device"], clock)
        names = sorted(f[: -len(".neoantigens.tsv")]
                       for f in os.listdir(out["st"]))
        check(len(names) == CHROMOSOME[0],
              f"neoantigen[{head}]: {len(names)} reports")
        fp32, cut32 = compare_rows(out["gpu"], out["st"], names, FP32_RTOL,
                                   f"neoantigen[{head}] vs fp32")
        bat, cutb = compare_rows(out["gpu"], out["mt"], names, BATCHED_RTOL,
                                 f"neoantigen[{head}] vs batched")
        import jax

        path = "sharded" if jax.device_count() > 1 else (
            "compact" if "_compact_fn" in seen else (
                "dense-aligned" if "_dense_fn_aligned" in seen else "dense"))

        phase(f"neoantigen[{head}]", samples=len(names), path=path,
              devices=jax.device_count(), host_chunks=res.neo_host_chunks,
              cold_s=f"{times[0][0]:.3f}", warm_s=f"{times[1][0]:.3f}",
              compile_s=f"{times[0][1]:.3f}",
              max_rel_err_fp32=f"{fp32:.2e}", at_cut_fp32=cut32,
              max_rel_err_batched=f"{bat:.2e}", at_cut_batched=cutb)


def phase_debug_gpu(work, clock, gpu_out):
    import numpy as np

    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QC_OFF
    from vcf2prot_tpu.frontend.fasta import read_fasta
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.runtime import kernels
    from vcf2prot_tpu.runtime.device_engine import DeviceEngine
    from vcf2prot_tpu.runtime.pack import pack_cohort, pad_to_bucket

    vcf, fasta = cohort(*CHROMOSOME)
    out = fresh_dir(os.path.join(work, "debug_gpu"))
    saved = {k: os.environ.pop(k, None)
             for k in ("NO_TEST", "RUN_SELECTED_TEST", "DEBUG_GPU")}
    os.environ.update(RUN_SELECTED_TEST="1", DEBUG_GPU="1")
    try:
        wall, _ = run_cli(["-f", vcf, "-r", fasta, "-o", out, "-g", "gpu"],
                          clock)
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    same_dirs(out, gpu_out, "debug-gpu run vs phase-2 gpu run")

    ref = read_fasta(fasta)
    blob = RefBlob.from_ref_seqs(ref)
    _p, programs, _w = compile_cohort_native(vcf, ref, blob, QC_OFF)
    bad = list(programs)
    victim = next(i for i, p in enumerate(bad) if p.n_tasks > 1)
    prog = bad[victim]
    import copy

    prog = copy.copy(prog)
    prog.dst = prog.dst.copy()
    prog.dst[1] += 3
    bad[victim] = prog
    try:
        DeviceEngine(blob, validate_on_device=True).execute(bad)
    except AssertionError as err:
        caught = "validation failed" in str(err)
    else:
        caught = False
    check(caught, "DEBUG_GPU did not catch a corrupted dst")

    # the validator beside the execute it guards, on the same chunk
    import jax

    dev = jax.devices()[0]
    packed = pack_cohort(programs, blob)
    n = len(packed.dst)
    padded = pad_to_bucket(n)
    arrs = []
    for a in (packed.dst, packed.length, packed.src_biased):
        p = np.zeros(padded, np.int32)
        p[:n] = a
        arrs.append(jax.device_put(p, dev))
    vargs = (*arrs, np.int32(n), np.int32(len(blob.data) + len(packed.alt)),
             np.int32(packed.total_res))
    validate_ms = device_ms(kernels._validator(), vargs)
    call_ms = device_ms(
        lambda: kernels.check_packed(packed, len(blob.data), dev), ()
    )
    eng = DeviceEngine(blob)
    execute_ms = device_ms(lambda: eng._launch(packed), ())
    phase("debug-gpu", run_s=f"{wall:.3f}", good_cohort="pass",
          corrupted_dst="raised", validator_kernel_ms=f"{validate_ms:.3f}",
          validator_call_ms=f"{call_ms:.3f}",
          execute_call_ms=f"{execute_ms:.3f}", tasks=n)


def phase_kernels(jits, kind):
    import numpy as np

    import jax
    import jax.numpy as jnp

    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QC_OFF
    from vcf2prot_tpu.frontend.fasta import read_fasta
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.runtime.device_engine import (
        _get_aligned_jitted,
        _get_jitted,
        build_aligned_program,
        pad_aligned_program,
    )
    from vcf2prot_tpu.runtime.pack import pack_cohort, pad_to_bucket
    from vcf2prot_tpu.utils.roofline import hbm_fraction, peaks

    peaks(kind)  # a card without published peaks fails here
    vcf, fasta = cohort(*PROTEOME)
    ref = read_fasta(fasta)
    blob = RefBlob.from_ref_seqs(ref)
    _p, programs, _w = compile_cohort_native(vcf, ref, blob, QC_OFF)
    packed = pack_cohort(programs, blob)
    check(packed.contiguous and packed.dst.dtype == np.int32,
          "phase-3 chunk is not an int32 contiguous pack")
    dev = jax.devices()[0]
    ob = pad_to_bucket(packed.total_res)
    tb = pad_to_bucket(len(packed.dst))
    alt = np.zeros(pad_to_bucket(max(len(packed.alt), 1)), np.uint8)
    alt[: len(packed.alt)] = packed.alt
    combined = jnp.concatenate(
        [jax.device_put(blob.data, dev), jax.device_put(alt, dev)]
    )
    prog = build_aligned_program(packed.dst, packed.src_biased,
                                 packed.total_res, int(combined.shape[0]))
    aligned_args = (combined, *(
        jax.device_put(a, dev) for a in pad_aligned_program(
            *prog, tb, ob, pad_to_bucket(max(len(prog[2]), 1)))
    ))
    dst = np.full(tb, np.iinfo(np.int32).max, np.int32)
    dst[: len(packed.dst)] = packed.dst
    srcb = np.zeros(tb, np.int32)
    srcb[: len(packed.src_biased)] = packed.src_biased
    byte_args = (combined, jax.device_put(dst, dev),
                 jax.device_put(srcb, dev))
    aligned_fn = _get_aligned_jitted()(ob)
    byte_fn = _get_jitted()(ob)
    a_out = aligned_fn(*aligned_args)[: packed.total_res]
    b_out = byte_fn(*byte_args)[: packed.total_res]
    check(bool(jnp.array_equal(a_out, b_out)),
          "aligned and per-byte executors disagree")
    del a_out, b_out
    readings = {
        "exec_aligned": (aligned_fn, aligned_args),
        "exec_per_byte": (byte_fn, byte_args),
    }
    for head, seen in jits.items():
        for name, (fn, args) in seen.items():
            readings[f"{name.strip('_')}[{head}]"] = (fn, args)
    for name, (fn, args) in readings.items():
        ms = device_ms(fn, args)
        mem, xla_bytes = compiled_stats(fn, args)
        fields = {"ms": f"{ms:.3f}", "mem": mem}
        if name.startswith("exec_"):
            fields["out_mb"] = f"{packed.total_res / 1e6:.1f}"
            fields["out_gb_s"] = f"{packed.total_res / ms / 1e6:.2f}"
        # XLA's byte count is a model of the compiled program's traffic,
        # not a counter reading
        fields["xla_bytes_mb"] = f"{xla_bytes / 1e6:.1f}"
        fields["hbm_share_xla_bytes"] = (
            f"{hbm_fraction(xla_bytes, ms / 1e3, kind):.4f}"
        )
        phase(f"kernels:{name}", **fields)


# ------------------------------------------------------------------- main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phases 2 and 4 on four cards through the "
                         "dp-sharded engines, and no other phase")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    if not args.four_cards:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    # synthetic cohorts trip the reference's QC; the bench runs so too
    os.environ.setdefault("NO_TEST", "1")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax

    import vcf2prot_tpu  # noqa: F401  (fails outside the repo)

    dev = phase_env(jax, count)
    clock = CompileClock(jax)
    work = fresh_dir(os.path.join(CACHE, "work"))
    jits = {}
    gpu_out = phase_fasta("fasta-chromosome", CHROMOSOME, work, clock)
    if not args.four_cards:
        phase_fasta("fasta-proteome", PROTEOME, work, clock)
    phase_neoantigen(work, clock, jits)
    if not args.four_cards:
        phase_debug_gpu(work, clock, gpu_out)
        phase_kernels(jits, dev.device_kind)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()

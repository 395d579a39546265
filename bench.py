#!/usr/bin/env python
"""Benchmark harness.

Protocol mirrors the reference's published comparison methodology
(reference: automation_scripts/performance_benchmark.py:62-100): wall-clock a
single end-to-end invocation over a chromosome-scale synthetic cohort, after a
page-cache warmup pass. The baseline is the reference's own multi-threaded
engine (its prebuilt Linux binary) on this machine; ``vs_baseline`` is the
throughput ratio (ours / reference), so > 1.0 means faster than the reference.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

REF_BIN = "/root/reference/bins/Linux/vcf2prot"
WORKDIR = os.path.join(tempfile.gettempdir(), "vcf2prot_bench")
N_SAMPLES = int(os.environ.get("BENCH_SAMPLES", "128"))
N_TRANSCRIPTS = int(os.environ.get("BENCH_TRANSCRIPTS", "1200"))
SEED = 20260817


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def prepare_workload():
    from genvcf import random_cohort, write_fasta, write_synthetic_vcf

    os.makedirs(WORKDIR, exist_ok=True)
    vcf = os.path.join(WORKDIR, f"cohort_{N_SAMPLES}x{N_TRANSCRIPTS}.vcf")
    fasta = os.path.join(WORKDIR, f"ref_{N_TRANSCRIPTS}.fasta")
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        log(f"generating workload: {N_SAMPLES} samples x {N_TRANSCRIPTS} transcripts")
        ref, samples = random_cohort(
            seed=SEED, n_samples=N_SAMPLES, n_transcripts=N_TRANSCRIPTS
        )
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)
    return vcf, fasta


def run_reference(vcf, fasta):
    outdir = os.path.join(WORKDIR, "ref_out")
    env = dict(os.environ, NO_TEST="1")
    cmd = [REF_BIN, "-f", vcf, "-r", fasta, "-o", outdir, "-g", "mt"]
    times = []
    # warmup (page cache) + 2 timed runs, best taken -- the reference's own
    # protocol, hardened against co-tenant noise
    for rep in range(3):
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        t0 = time.perf_counter()
        subprocess.run(cmd, env=env, capture_output=True, check=True)
        if rep > 0:
            times.append(time.perf_counter() - t0)
    dt = min(times)
    log(f"reference mt: {dt:.3f}s best of {len(times)} "
        f"({N_SAMPLES / dt:.2f} samples/s)")
    return dt


def run_ours(vcf, fasta):
    from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
    from vcf2prot_tpu.runtime.engine import Engine

    outdir = os.path.join(WORKDIR, "our_out")

    def one_run():
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        cfg = PipelineConfig(
            vcf_path=vcf,
            fasta_path=fasta,
            outdir=outdir,
            engine=Engine.from_str(os.environ.get("BENCH_ENGINE", "auto")),
            num_threads=os.cpu_count(),
            qc=None,
        )
        t0 = time.perf_counter()
        res = run_pipeline(cfg)
        return time.perf_counter() - t0, res

    one_run()  # warmup: page cache + jit compilation
    results = [one_run() for _ in range(3)]
    dt, res = min(results, key=lambda r: r[0])
    engine_name = os.environ.get("BENCH_ENGINE", "auto")
    log(f"ours ({engine_name}): {dt:.3f}s best of 3 "
        f"({N_SAMPLES / dt:.2f} samples/s)")
    for k, v in sorted(res.durations.items()):
        log(f"  {k}: {v:.3f}s")
    log(
        f"  {res.n_haplotype_seqs} haplotype seqs, "
        f"{res.total_output_bytes / 1e6:.1f} MB output"
    )
    return dt, res


def device_info():
    """(platform, device_kind) of JAX's default device, plus the card's
    name and power limit from nvidia-smi on a GPU host."""
    import jax

    dev = jax.devices()[0]
    card = ""
    if dev.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    return dev.platform, dev.device_kind, card


def measure_device_throughput(vcf, fasta):
    """Warm device-execute throughput of the word-aligned executor (the
    kernel itself, inputs pre-uploaded), reported to stderr; returns output
    GB/s, or None off a GPU."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import default_qc
    from vcf2prot_tpu.frontend.fasta import read_fasta
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.runtime.device_engine import (
        _get_aligned_jitted,
        build_aligned_program,
        pad_aligned_program,
    )
    from vcf2prot_tpu.runtime.pack import pack_cohort, pad_to_bucket

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        return None
    ref = read_fasta(fasta)
    blob = RefBlob.from_ref_seqs(ref)
    _p, programs, _w = compile_cohort_native(vcf, ref, blob, default_qc())
    packed = pack_cohort(programs, blob)
    ob = pad_to_bucket(packed.total_res)
    combined = jnp.concatenate(
        [jax.device_put(blob.data, dev), jax.device_put(packed.alt, dev)]
    )
    prog = build_aligned_program(
        packed.dst, packed.src_biased, packed.total_res,
        int(combined.shape[0]),
    )
    args = tuple(
        jax.device_put(a, dev) for a in pad_aligned_program(
            *prog, pad_to_bucket(len(packed.dst)), ob,
            pad_to_bucket(max(len(prog[2]), 1)),
        )
    )
    run = _get_aligned_jitted()(ob)
    run(combined, *args).block_until_ready()  # compile
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(combined, *args)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    gbps = packed.total_res / dt / 1e9
    log(
        f"device execute (kernel only, {packed.total_res / 1e6:.1f} MB "
        f"result): {dt * 1e3:.3f} ms/iter = {gbps:.3f} GB/s output"
    )
    return gbps


def measure_shared_regime():
    """Shared-variant (1000G-like) cohort regime: the adaptive alt pool and
    compile memo must stay ON here. Reported to stderr every round so both
    regimes (near-unique main bench + shared bundles) are continuously
    measured. Disable with BENCH_SHARED=0."""
    from genvcf import shared_cohort, write_fasta, write_synthetic_vcf

    n_samples = int(os.environ.get("BENCH_SHARED_SAMPLES", "128"))
    n_txp = int(os.environ.get("BENCH_SHARED_TRANSCRIPTS", "400"))
    vcf = os.path.join(WORKDIR, f"shared_{n_samples}x{n_txp}.vcf")
    fasta = os.path.join(WORKDIR, f"shared_ref_{n_txp}.fasta")
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        log(f"generating shared-variant cohort: {n_samples} x {n_txp}")
        ref, samples = shared_cohort(
            seed=SEED, n_samples=n_samples, n_transcripts=n_txp
        )
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)

    from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
    from vcf2prot_tpu.runtime.engine import Engine

    outdir = os.path.join(WORKDIR, "shared_out")

    def one_run():
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        cfg = PipelineConfig(
            vcf_path=vcf, fasta_path=fasta, outdir=outdir,
            engine=Engine.MT, num_threads=os.cpu_count(), qc=None,
        )
        t0 = time.perf_counter()
        run_pipeline(cfg)
        return time.perf_counter() - t0

    one_run()
    ours = min(one_run() for _ in range(2))
    line = (f"shared-variant regime (mt): {ours:.3f}s "
            f"({n_samples / ours:.2f} samples/s)")
    if os.access(REF_BIN, os.X_OK):
        ref_out = os.path.join(WORKDIR, "shared_ref_out")
        env = dict(os.environ, NO_TEST="1")
        cmd = [REF_BIN, "-f", vcf, "-r", fasta, "-o", ref_out, "-g", "mt"]
        best = None
        for rep in range(2):
            shutil.rmtree(ref_out, ignore_errors=True)
            os.makedirs(ref_out)
            t0 = time.perf_counter()
            subprocess.run(cmd, env=env, capture_output=True, check=True)
            if rep > 0:
                best = time.perf_counter() - t0
        line += (f"; reference: {best:.3f}s "
                 f"({n_samples / best:.2f} samples/s) -> "
                 f"{best / ours:.1f}x")
    log(line)


def neo_legs(vcf, fasta, outbase):
    """Device-resident neoantigen run and the host-execute run on the same
    cohort, both in this process (one process per card): ``{mode: {"cold":
    s, "dt": best warm s}}`` for mode ``device`` and ``mt``. Cold includes
    the page cache and jit compiles."""
    from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
    from vcf2prot_tpu.runtime.engine import Engine

    def one(mode):
        outdir = f"{outbase}_{mode}"
        shutil.rmtree(outdir, ignore_errors=True)
        os.makedirs(outdir)
        cfg = PipelineConfig(
            vcf_path=vcf, fasta_path=fasta, outdir=outdir,
            engine=Engine.DEVICE if mode == "device" else Engine.MT,
            num_threads=os.cpu_count(), qc=None,
            neoantigen_k=9, neoantigen_only=True,
            neoantigen_device=(mode != "device"),
        )
        t0 = time.perf_counter()
        run_pipeline(cfg)
        return time.perf_counter() - t0

    out = {}
    for mode in ("device", "mt"):
        cold = one(mode)
        out[mode] = {"cold": cold, "dt": min(one(mode) for _ in range(2))}
    return out


def measure_neoantigen_e2e():
    """End-to-end device-resident neoantigen run vs the host-execute path
    on the same cohort: the workload where only [S, top] rows leave the
    device. Disable with BENCH_NEOANTIGEN=0. Defaults to the headline
    cohort (128x1200; BENCH_NEO_SAMPLES / BENCH_NEO_TRANSCRIPTS resize)."""
    from genvcf import random_cohort, write_fasta, write_synthetic_vcf

    n_samples = int(os.environ.get("BENCH_NEO_SAMPLES", str(N_SAMPLES)))
    n_txp = int(os.environ.get("BENCH_NEO_TRANSCRIPTS", str(N_TRANSCRIPTS)))
    vcf = os.path.join(WORKDIR, f"cohort_{n_samples}x{n_txp}.vcf")
    fasta = os.path.join(WORKDIR, f"ref_{n_txp}.fasta")
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        log(f"generating neoantigen cohort: {n_samples} x {n_txp}")
        ref, samples = random_cohort(
            seed=SEED, n_samples=n_samples, n_transcripts=n_txp
        )
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)
    results = neo_legs(vcf, fasta, os.path.join(WORKDIR, "neo"))
    for mode, label in (("device", "device-resident"),
                        ("mt", "host-execute")):
        r = results[mode]
        log(f"neoantigen e2e ({label}, {n_samples}x{n_txp}, k=9 "
            f"top-200): {r['dt']:.3f}s warm "
            f"({n_samples / r['dt']:.2f} samples/s), "
            f"cold {r['cold']:.3f}s")
    log(f"neoantigen device/host speed ratio: "
        f"{results['mt']['dt'] / results['device']['dt']:.2f}x warm")
    return results


def main():
    os.environ.setdefault("NO_TEST", "1")
    vcf, fasta = prepare_workload()
    platform, kind, card = device_info()
    log(f"device: platform={platform} device_kind={kind}"
        + (f" card={card}" if card else ""))
    ours_dt, res = run_ours(vcf, fasta)
    if os.access(REF_BIN, os.X_OK):
        ref_dt = run_reference(vcf, fasta)
        vs_baseline = ref_dt / ours_dt
    else:
        vs_baseline = float("nan")
    # structured fields for the device story: carried in the parsed stdout
    # JSON (stderr stays the human-readable diagnostic log)
    extra = {"platform": platform, "device_kind": kind}
    if os.environ.get("BENCH_DEVICE_METRIC", "1") == "1":
        gbps = measure_device_throughput(vcf, fasta)
        if gbps is not None:
            extra["kernel_gbps"] = round(gbps, 4)
    if os.environ.get("BENCH_NEOANTIGEN", "1") == "1":
        neo = measure_neoantigen_e2e()
        extra["neo_device_warm_s"] = round(neo["device"]["dt"], 3)
        extra["neo_cold_s"] = round(neo["device"]["cold"], 3)
        extra["neo_host_warm_s"] = round(neo["mt"]["dt"], 3)
        extra["neo_host_cold_s"] = round(neo["mt"]["cold"], 3)
        extra["neo_ratio"] = round(neo["mt"]["dt"] / neo["device"]["dt"], 3)
        extra["neo_cold_ratio"] = round(
            neo["mt"]["cold"] / neo["device"]["cold"], 3
        )
    if os.environ.get("BENCH_SHARED", "1") == "1":
        measure_shared_regime()
    print(
        json.dumps(
            {
                "metric": "end_to_end_samples_per_sec",
                "value": round(N_SAMPLES / ours_dt, 3),
                "unit": "samples/s",
                "vs_baseline": round(vs_baseline, 3),
                **extra,
            }
        )
    )


if __name__ == "__main__":
    main()

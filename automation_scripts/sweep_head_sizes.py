#!/usr/bin/env python
"""Head-size sweep of the neoantigen e2e: device-resident vs host-execute.

At the scaffold head the chain is gather/sort-bound and the matrix units
idle. This sweep holds the cohort fixed (the standard 128x1200 headline
workload) and scales the scoring head's arithmetic intensity (hidden in
{128, 512, 2048} and a deep variant), measuring every leg of one config in
one subprocess (the configs run one after another, so one process holds
the card at a time; this parent stays on the CPU). Expectation: the
device/host ratio grows with head width because the extra FLOPs ride the
tensor cores on device but multiply the host's matmul time.

Writes automation_scripts/artifacts/head_size_sweep.tsv and prints progress
to stderr.

    python -u automation_scripts/sweep_head_sizes.py
Env: SWEEP_SAMPLES (128), SWEEP_TRANSCRIPTS (1200), SWEEP_CONFIGS
     ("128x1,512x1,2048x1,512x3" as HxDEPTH), SWEEP_TIMEOUT (1500 s per
     config).
"""
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

N_SAMPLES = int(os.environ.get("SWEEP_SAMPLES", "128"))
N_TXP = int(os.environ.get("SWEEP_TRANSCRIPTS", "1200"))
TIMEOUT = int(os.environ.get("SWEEP_TIMEOUT", "1500"))
WORKDIR = os.path.join(tempfile.gettempdir(), "vcf2prot_headsweep")
ART = os.path.join(REPO, "automation_scripts", "artifacts",
                   "head_size_sweep.tsv")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_SNIPPET = r"""
import json, sys, time, shutil, os
os.environ.setdefault("NO_TEST", "1")
repo, vcf, fasta, outbase, npz = sys.argv[1:6]
sys.path.insert(0, repo)
import jax
from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu.runtime.engine import Engine
def one(mode):
    # device = fully device-resident chain;
    # mt   = hybrid: host execute + host collection + ONE device scoring
    #        batch (the best host-centric design with a GPU present);
    # host = pure host: numpy scoring, no accelerator anywhere -- the
    #        reference's actual capability level (its GPU engine is a stub)
    outdir = outbase + "_" + mode
    shutil.rmtree(outdir, ignore_errors=True); os.makedirs(outdir)
    cfg = PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=outdir,
        engine=Engine.DEVICE if mode == "device" else Engine.MT,
        num_threads=os.cpu_count(), qc=None,
        neoantigen_k=9, neoantigen_only=True,
        neoantigen_device=(mode == "mt"),
        neoantigen_params=npz,
    )
    t0 = time.perf_counter(); run_pipeline(cfg)
    return time.perf_counter() - t0
out = {"device_kind": jax.devices()[0].device_kind}
for mode in ("device", "mt"):
    cold = one(mode)
    out[mode] = {"cold": cold, "dt": min(one(mode) for _ in range(2))}
if os.environ.get("SWEEP_HOST_ONLY", "1") == "1":
    cold = one("host")  # pure-host leg: 1 warm rep (it is the slow anchor)
    out["host"] = {"cold": cold, "dt": one("host")}
print(json.dumps(out))
"""


def main():
    os.makedirs(WORKDIR, exist_ok=True)
    os.makedirs(os.path.dirname(ART), exist_ok=True)
    from genvcf import random_cohort, write_fasta, write_synthetic_vcf

    vcf = os.path.join(WORKDIR, f"c_{N_SAMPLES}x{N_TXP}.vcf")
    fasta = os.path.join(WORKDIR, f"r_{N_TXP}.fasta")
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        log(f"generating cohort {N_SAMPLES}x{N_TXP}")
        ref, samples = random_cohort(
            seed=20260817, n_samples=N_SAMPLES, n_transcripts=N_TXP
        )
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)

    # window/FLOP accounting for the MFU column (host-side, cheap)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vcf2prot_tpu.compiler.haplotype import RefBlob
    from vcf2prot_tpu.compiler.qc import QC_OFF
    from vcf2prot_tpu.downstream.device_resident import run_buckets
    from vcf2prot_tpu.downstream.scoring import init_params
    from vcf2prot_tpu.downstream.train import save_params
    from vcf2prot_tpu.frontend import fasta as fasta_mod
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.pipeline import _chunk_indices
    from vcf2prot_tpu.utils.roofline import (
        mfu,
        scoring_flops_per_window,
    )

    ref_seqs = fasta_mod.read_fasta(fasta)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _, programs, _ = compile_cohort_native(vcf, ref_seqs, blob, QC_OFF)
    chunks = _chunk_indices(programs, 256 * 1024 * 1024, pair_aligned=True)
    buckets = run_buckets(programs, chunks)
    scored_windows = buckets.out * len(chunks)
    log(f"{len(chunks)} chunk(s), out bucket {buckets.out} "
        f"-> {scored_windows / 1e6:.1f} M windows scored per run")

    configs = []
    for tok in os.environ.get(
        "SWEEP_CONFIGS", "128x1,512x1,2048x1,512x3"
    ).split(","):
        h, d = tok.split("x")
        configs.append((int(h), int(d)))

    rows = []
    for hidden, depth in configs:
        label = f"H{hidden}x{depth}"
        params = init_params(9, hidden=hidden, depth=depth, seed=0)
        npz = os.path.join(WORKDIR, f"params_{label}.npz")
        save_params(npz, params)
        flops_run = scored_windows * scoring_flops_per_window(params)
        log(f"--- {label}: {scoring_flops_per_window(params) / 1e3:.0f} "
            f"kFLOP/window, {flops_run / 1e12:.2f} TFLOP/run")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _SNIPPET, REPO, vcf, fasta,
             os.path.join(WORKDIR, f"neo_{label}"), npz],
            capture_output=True, timeout=TIMEOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{label} failed:\n{proc.stderr[-2000:]}")
        results = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"{label}: subprocess took {time.perf_counter() - t0:.0f}s")
        dev, host = results["device"], results["mt"]
        pure = results.get("host")
        ratio = host["dt"] / dev["dt"]
        ratio_cold = host["cold"] / dev["cold"]
        pure_warm = pure["dt"] if pure else float("nan")
        pure_ratio = pure["dt"] / dev["dt"] if pure else float("nan")
        chain_mfu = mfu(flops_run, dev["dt"], results["device_kind"])
        rows.append(
            (label, hidden, depth, dev["cold"], dev["dt"], host["cold"],
             host["dt"], pure_warm, ratio, ratio_cold, pure_ratio,
             chain_mfu)
        )
        log(f"{label}: device {dev['dt']:.2f}s warm / {dev['cold']:.2f}s "
            f"cold; hybrid {host['dt']:.2f}s warm / {host['cold']:.2f}s "
            f"cold; pure-host {pure_warm:.2f}s; ratio {ratio:.2f}x warm "
            f"{ratio_cold:.2f}x cold, {pure_ratio:.1f}x vs pure-host; "
            f"e2e MFU {chain_mfu * 100:.1f}%")

    with open(ART, "w") as fh:
        fh.write(
            "# head-size sweep: neoantigen e2e, three tiers on the "
            f"{N_SAMPLES}x{N_TXP} cohort, k=9 top-200. dev = fully "
            "device-resident; hybrid = host execute/collect + one device "
            "scoring batch; pure_host = numpy scoring, no accelerator "
            "(the reference's capability level). warm = best of 2 after "
            "cold (pure_host: 1 rep); e2e_mfu = scored-window matmul "
            "FLOPs / device warm wall / bf16 peak\n"
        )
        fh.write("\t".join([
            "label", "hidden", "depth", "dev_cold_s", "dev_warm_s",
            "hybrid_cold_s", "hybrid_warm_s", "pure_host_warm_s",
            "ratio_warm", "ratio_cold", "ratio_vs_pure_host", "e2e_mfu",
        ]) + "\n")
        for r in rows:
            fh.write(
                f"{r[0]}\t{r[1]}\t{r[2]}\t{r[3]:.3f}\t{r[4]:.3f}\t"
                f"{r[5]:.3f}\t{r[6]:.3f}\t{r[7]:.3f}\t{r[8]:.3f}\t"
                f"{r[9]:.3f}\t{r[10]:.3f}\t{r[11]:.4f}\n"
            )
    log(f"wrote {ART} ({len(rows)} rows)")


if __name__ == "__main__":
    main()

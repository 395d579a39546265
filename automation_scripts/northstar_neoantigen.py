#!/usr/bin/env python
"""North-star neoantigen measurement: the flagship device-resident number.

Measures, at the 2,504-sample north-star cohort (BASELINE.json's scale,
shared-variant regime like northstar_scale.py), the end-to-end wall of:

* ``resident``  -- the fully device-resident chain (--neoantigen_only -g
  gpu): execute + mask + bf16 score + rank on the device, only [S, top]
  rows leave it; swept over chunk sizes (NEO_CHUNK_MB list).
* ``hybrid``    -- the best host-centric design with a GPU present: host
  execute + native candidate collection + one bucketed device scoring
  batch (--neoantigen_device -g mt).

Each leg runs in its own subprocess, one after another, so exactly one
process holds the card at a time (this parent never starts JAX); cold and
warm walls recorded. Writes
``automation_scripts/artifacts/northstar_neoantigen.tsv`` (reference
analogue: the TSV protocol of the reference's
automation_scripts/performance_benchmark.py:95-100).

Usage:  python -u automation_scripts/northstar_neoantigen.py
Env:    NS_SAMPLES (2504), NS_TRANSCRIPTS (2000), NEO_CHUNK_MB
        ("128,256"), NS_HYBRID=0 to skip the hybrid leg
"""
import json
import os
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

N_SAMPLES = int(os.environ.get("NS_SAMPLES", "2504"))
N_TXP = int(os.environ.get("NS_TRANSCRIPTS", "2000"))
CHUNK_MB = [int(c) for c in os.environ.get("NEO_CHUNK_MB",
                                           "128,256").split(",")]
TIMEOUT = int(os.environ.get("NS_TIMEOUT", "1800"))
K = 9
ART = os.path.join(_ROOT, "automation_scripts", "artifacts",
                   "northstar_neoantigen.tsv")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_LEG = r"""
import json, sys, time, shutil, os
os.environ.setdefault("NO_TEST", "1")
repo, vcf, fasta, outdir, mode, chunk_mb = sys.argv[1:7]
sys.path.insert(0, repo)
import jax
from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline
from vcf2prot_tpu.runtime.engine import Engine
def one():
    shutil.rmtree(outdir, ignore_errors=True); os.makedirs(outdir)
    cfg = PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=outdir,
        engine=Engine.DEVICE if mode == "resident" else Engine.MT,
        num_threads=os.cpu_count(), qc=None,
        neoantigen_k=9, neoantigen_only=True,
        neoantigen_device=(mode != "resident"),
        chunk_res_bytes=int(chunk_mb) * 1024 * 1024 if int(chunk_mb) else None,
    )
    t0 = time.perf_counter(); res = run_pipeline(cfg)
    return time.perf_counter() - t0, res
cold, res = one()
warm = min(one()[0] for _ in range(2))
print(json.dumps({
    "cold": cold, "warm": warm, "samples": res.n_samples,
    "tape_bytes": res.total_output_bytes,
    "device_kind": jax.devices()[0].device_kind,
}))
"""


def run_leg(vcf, fasta, mode, chunk_mb):
    outdir = os.path.join(tempfile.gettempdir(), "vcf2prot_northstar",
                          f"neo_{mode}_{chunk_mb}")
    proc = subprocess.run(
        [sys.executable, "-c", _LEG, _ROOT, vcf, fasta, outdir, mode,
         str(chunk_mb)],
        capture_output=True, timeout=TIMEOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{mode}/{chunk_mb}MB leg failed:\n"
                           f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    os.environ.setdefault("NO_TEST", "1")
    from northstar_scale import prepare

    t0 = time.perf_counter()
    vcf, fasta = prepare(N_SAMPLES, N_TXP)
    log(f"cohort ready in {time.perf_counter() - t0:.0f}s")

    rows = []
    best_resident = None
    for chunk_mb in CHUNK_MB:
        r = run_leg(vcf, fasta, "resident", chunk_mb)
        log(f"resident {chunk_mb}MB chunks: warm {r['warm']:.1f}s "
            f"({r['samples'] / r['warm']:.0f} samples/s), cold "
            f"{r['cold']:.1f}s, tape {r['tape_bytes'] / 1e9:.2f} GB")
        rows.append(("resident", chunk_mb, r))
        if best_resident is None or r["warm"] < best_resident[1]["warm"]:
            best_resident = (chunk_mb, r)
    hybrid = None
    if os.environ.get("NS_HYBRID", "1") == "1":
        hybrid = run_leg(vcf, fasta, "hybrid", 0)
        log(f"hybrid (host execute + device batch score): warm "
            f"{hybrid['warm']:.1f}s, cold {hybrid['cold']:.1f}s")
        rows.append(("hybrid", 0, hybrid))

    # e2e MFU of the best resident config: dense-pass FLOPs over the whole
    # tape (the chain scores out_bucket lanes per chunk) / wall / the bf16
    # peak of the device the leg ran on
    from vcf2prot_tpu.downstream.scoring import init_params
    from vcf2prot_tpu.utils.roofline import mfu, scoring_flops_per_window

    mfu_pct = None
    if best_resident:
        flops = (
            scoring_flops_per_window(init_params(K))
            * best_resident[1]["tape_bytes"]
        )
        mfu_pct = mfu(flops, best_resident[1]["warm"],
                      best_resident[1]["device_kind"]) * 100

    os.makedirs(os.path.dirname(ART), exist_ok=True)
    with open(ART, "w") as fh:
        fh.write(
            "tier\tchunk_mb\tcold_s\twarm_s\tsamples_per_s\tratio_vs_hybrid"
            "\te2e_mfu_pct\tsamples\ttranscripts\n"
        )
        for tier, chunk_mb, r in rows:
            ratio = (
                f"{hybrid['warm'] / r['warm']:.2f}"
                if hybrid and tier == "resident" else ""
            )
            m = (
                f"{mfu_pct:.2f}"
                if best_resident and tier == "resident"
                and chunk_mb == best_resident[0] else ""
            )
            fh.write(
                f"{tier}\t{chunk_mb}\t{r['cold']:.1f}\t{r['warm']:.1f}\t"
                f"{r['samples'] / r['warm']:.1f}\t{ratio}\t{m}\t"
                f"{N_SAMPLES}\t{N_TXP}\n"
            )
    log(f"wrote {ART}")
    out = {"metric": "northstar_neoantigen_warm_s"}
    if best_resident:
        out["value"] = round(best_resident[1]["warm"], 2)
        out["chunk_mb"] = best_resident[0]
        if hybrid:
            out["ratio_vs_hybrid"] = round(
                hybrid["warm"] / best_resident[1]["warm"], 2
            )
    print(json.dumps(out))


if __name__ == "__main__":
    main()

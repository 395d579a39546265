#!/usr/bin/env python
"""Interleaved A/B of the native parse+compile stage across two builds.

Times native.compile_cohort on a near-unique scan-bound cohort (default
1024x1200) against a second build of the extension compiled from an older
revision of the source -- interleaved best-of-N so co-tenant drift hits
both sides equally (on a shared host only a same-minute ratio is stable).
Used to measure the tab-only AVX2 carrier walk.

Usage:  OLD_REF=<git-rev> python -u automation_scripts/ab_scan_walk.py
Env:    AB_SAMPLES (1024), AB_TRANSCRIPTS (1200), AB_REPS (5),
        OLD_REF (required: git revision providing the baseline .cpp)
"""
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

N_SAMPLES = int(os.environ.get("AB_SAMPLES", "1024"))
N_TXP = int(os.environ.get("AB_TRANSCRIPTS", "1200"))
REPS = int(os.environ.get("AB_REPS", "5"))
OLD_REF = os.environ.get("OLD_REF")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# one measurement per child process: a CPython extension's init symbol is
# tied to its module name, so two builds of the same module cannot coexist
# in one interpreter
_CHILD = r"""
import importlib.util, os, sys, time
import numpy as np
so, vcf, fasta, root = sys.argv[1:5]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("vcf2prot_native", so)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
from vcf2prot_tpu.frontend.fasta import read_fasta
ref_seqs = read_fasta(fasta)
names = list(ref_seqs.keys())
offsets = np.zeros(len(names) + 1, dtype=np.int64)
for i, n in enumerate(names):
    offsets[i + 1] = offsets[i] + len(ref_seqs[n])
t0 = time.perf_counter()
mod.compile_cohort(vcf, names, offsets.tobytes(), qc_flags=0,
                   n_threads=os.cpu_count(), ann_arrays=1, alt_pool=2)
print(time.perf_counter() - t0)
"""


def main():
    if not OLD_REF:
        log("set OLD_REF=<git revision> for the baseline build")
        return
    from genvcf import random_cohort, write_fasta, write_synthetic_vcf
    from vcf2prot_tpu.native_bridge import _SRC, _build_native, load_native

    assert load_native() is not None  # ensures the NEW .so exists
    new_so = os.path.join(os.path.dirname(_SRC), "build",
                          "vcf2prot_native.so")
    old_cpp = "/tmp/ab_old_native.cpp"
    old_so = "/tmp/ab_old_native.so"
    src = subprocess.run(
        ["git", "-C", _ROOT, "show", f"{OLD_REF}:native/vcf2prot_native.cpp"],
        capture_output=True, text=True, check=True,
    ).stdout
    with open(old_cpp, "w") as fh:
        fh.write(src)
    if not _build_native(old_cpp, old_so):
        log("baseline build failed")
        return
    workdir = "/tmp/vcf2prot_neochain"
    os.makedirs(workdir, exist_ok=True)
    vcf = os.path.join(workdir, f"c_{N_SAMPLES}x{N_TXP}.vcf")
    fasta = os.path.join(workdir, f"r_{N_TXP}_{N_SAMPLES}.vcf.fa")
    if not (os.path.exists(vcf) and os.path.exists(fasta)):
        ref, samples = random_cohort(
            seed=20260820, n_samples=N_SAMPLES, n_transcripts=N_TXP
        )
        write_synthetic_vcf(vcf, ref, samples)
        write_fasta(fasta, ref)
    sos = {"new": new_so, "old": old_so}

    def one(name):
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, sos[name], vcf, fasta, _ROOT],
            capture_output=True, text=True, check=True, timeout=600,
        )
        return float(out.stdout.strip().splitlines()[-1])

    for name in sos:  # warm page cache
        one(name)
    best = {"new": float("inf"), "old": float("inf")}
    for rep in range(REPS):
        for name in ("new", "old") if rep % 2 == 0 else ("old", "new"):
            dt = one(name)
            best[name] = min(best[name], dt)
            log(f"rep {rep + 1} {name}: {dt:.3f}s")
    log(f"best: new {best['new']:.3f}s, old {best['old']:.3f}s -> "
        f"{best['old'] / best['new']:.3f}x ({N_SAMPLES}x{N_TXP} cohort, "
        f"{os.path.getsize(vcf) / 1e6:.0f} MB VCF)")
    print(f"{best['old'] / best['new']:.3f}")


if __name__ == "__main__":
    main()

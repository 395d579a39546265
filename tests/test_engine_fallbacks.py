"""Engine placement and fallback paths: ``auto`` follows JAX's default
backend (device on a GPU, host mt otherwise), ``-g gpu`` refuses to run
without a GPU, and malformed programs defer to the host oracle."""
import os
import subprocess
import sys

import numpy as np
import pytest

from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu.compiler.haplotype import HaplotypeProgram, RefBlob
from vcf2prot_tpu.runtime.device_engine import DeviceEngine
from vcf2prot_tpu.runtime.engine import Engine, resolve_auto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def placement(monkeypatch):
    """``resolve_auto`` with its per-process answer cleared before and
    after the test; returns a setter for the backend JAX reports."""
    import jax

    resolve_auto.cache_clear()

    def backend(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    yield backend
    resolve_auto.cache_clear()


@pytest.fixture(scope="module")
def tiny_cohort(tmp_path_factory):
    d = tmp_path_factory.mktemp("placement")
    ref, samples = random_cohort(seed=8, n_samples=2, n_transcripts=5)
    vcf, fasta = str(d / "c.vcf"), str(d / "r.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fasta, ref)
    return d, vcf, fasta


def _neo_only_engine(tiny_cohort, monkeypatch, tmp_path):
    """The engine a ``--neoantigen_only`` auto run resolves to, read at
    the device-resident writer and the host report writer."""
    from vcf2prot_tpu.downstream import device_resident, report
    from vcf2prot_tpu.pipeline import PipelineConfig, run_pipeline

    seen = []
    real_dev = device_resident.write_device_neoantigen_reports
    real_host = report.write_neoantigen_report

    def dev(*a, **kw):
        seen.append(Engine.DEVICE)
        return real_dev(*a, **kw)

    def host(*a, **kw):
        seen.append(Engine.MT)
        return real_host(*a, **kw)

    monkeypatch.setattr(device_resident,
                        "write_device_neoantigen_reports", dev)
    monkeypatch.setattr(report, "write_neoantigen_report", host)
    _d, vcf, fasta = tiny_cohort
    run_pipeline(PipelineConfig(
        vcf_path=vcf, fasta_path=fasta, outdir=str(tmp_path),
        engine=Engine.AUTO, neoantigen_k=9, neoantigen_only=True,
    ))
    assert len(set(seen)) == 1, seen
    return seen[0]


def test_auto_resolves_to_host_on_cpu_platform(placement):
    placement("cpu")
    assert resolve_auto() is Engine.MT


def test_auto_selects_device_on_gpu_platform(placement):
    placement("gpu")
    assert resolve_auto() is Engine.DEVICE


def test_auto_neoantigen_only_on_cpu_runs_host(placement, tiny_cohort,
                                               monkeypatch, tmp_path):
    placement("cpu")
    assert _neo_only_engine(tiny_cohort, monkeypatch, tmp_path) is Engine.MT


def test_auto_neoantigen_only_on_gpu_runs_device(placement, tiny_cohort,
                                                 monkeypatch, tmp_path):
    # the device chain itself runs on the CPU backend here
    placement("gpu")
    assert (
        _neo_only_engine(tiny_cohort, monkeypatch, tmp_path) is Engine.DEVICE
    )


def test_gpu_flag_without_gpu_exits_1(tiny_cohort, tmp_path):
    from vcf2prot_tpu.cli import main

    _d, vcf, fasta = tiny_cohort
    with pytest.raises(SystemExit) as exc:
        main(["-f", vcf, "-r", fasta, "-o", str(tmp_path), "-g", "gpu"])
    assert exc.value.code == "error: no GPU visible to JAX"
    assert not os.listdir(tmp_path)  # nothing ran


def test_auto_is_decided_once_per_process(placement, monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(
        jax, "default_backend", lambda: calls.append(1) or "gpu"
    )
    assert resolve_auto() is Engine.DEVICE
    assert resolve_auto() is Engine.DEVICE
    assert len(calls) == 1


def test_mt_fasta_run_starts_no_jax_backend(tiny_cohort, tmp_path):
    """A ``-g mt`` FASTA run never initializes a JAX backend (checked in a
    fresh interpreter, since this one already has the CPU backend up)."""
    _d, vcf, fasta = tiny_cohort
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from vcf2prot_tpu.cli import main\n"
        f"assert main(['-f', {vcf!r}, '-r', {fasta!r}, '-o', "
        f"{str(tmp_path)!r}, '-g', 'mt']) == 0\n"
        "from jax._src import xla_bridge\n"
        "print(xla_bridge.backends_are_initialized())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, NO_TEST="1"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "False"
    assert any(f.endswith(".fasta") for f in os.listdir(tmp_path))


def test_non_contiguous_program_falls_back_to_oracle():
    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    # dst jumps (0 then 5): violates contiguity -> device path must defer to
    # the serial oracle, whose semantics fill the gap with '.'
    prog = HaplotypeProgram(
        exe=np.array([0, 0], np.uint8),
        src=np.array([0, 4], np.int64),
        length=np.array([2, 2], np.int64),
        dst=np.array([0, 5], np.int64),
        alt=b"",
        res_len=7,
        annotations=[("T", 0, 7)],
    )
    out = DeviceEngine(blob).execute([prog])[0]
    assert out.tobytes() == b"AB...EF"


def _mk_good(blob_text, start, length):
    return HaplotypeProgram(
        exe=np.array([0], np.uint8),
        src=np.array([start], np.int64),
        length=np.array([length], np.int64),
        dst=np.array([0], np.int64),
        alt=b"",
        res_len=length,
        annotations=[("T", 0, length)],
    )


def _mk_corrupt():
    return HaplotypeProgram(
        exe=np.array([0, 0], np.uint8),
        src=np.array([0, 4], np.int64),
        length=np.array([2, 2], np.int64),
        dst=np.array([0, 5], np.int64),  # gap -> non-contiguous
        alt=b"",
        res_len=7,
        annotations=[("T", 0, 7)],
    )


def test_one_corrupt_program_is_isolated_not_the_whole_chunk(monkeypatch):
    """10-program chunk, 1 corrupted: the oracle runs for exactly that one;
    the other 9 execute on the device path."""
    from vcf2prot_tpu.runtime import cpu_engine, device_engine

    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    progs = [_mk_good("T", i % 4, 4) for i in range(9)]
    progs.insert(3, _mk_corrupt())
    calls = []
    real = cpu_engine.execute_tasks

    def counting(p, b):
        calls.append(p)
        return real(p, b)

    monkeypatch.setattr(device_engine.cpu_engine, "execute_tasks", counting)
    outs = DeviceEngine(blob).execute(progs)
    assert len(calls) == 1 and calls[0] is progs[3]
    assert outs[3].tobytes() == b"AB...EF"
    for i, p in enumerate(progs):
        if i != 3:
            s = int(p.src[0])
            assert outs[i].tobytes() == b"ABCDEFGH"[s:s + 4]


def test_all_corrupt_chunk_still_full_oracle():
    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    outs = DeviceEngine(blob).execute([_mk_corrupt(), _mk_corrupt()])
    assert all(o.tobytes() == b"AB...EF" for o in outs)


def test_sharded_engine_isolates_corrupt_program(monkeypatch):
    from vcf2prot_tpu.parallel.mesh import make_mesh
    from vcf2prot_tpu.parallel.sharded import ShardedEngine
    from vcf2prot_tpu.runtime import cpu_engine

    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    progs = [_mk_good("T", i % 4, 4) for i in range(9)]
    progs.insert(5, _mk_corrupt())
    calls = []
    real = cpu_engine.execute_tasks

    def counting(p, b):
        calls.append(p)
        return real(p, b)

    monkeypatch.setattr(cpu_engine, "execute_tasks", counting)
    outs = ShardedEngine(blob, make_mesh()).execute(progs)
    assert len(calls) == 1 and calls[0] is progs[5]
    assert outs[5].tobytes() == b"AB...EF"
    for i, p in enumerate(progs):
        if i != 5:
            s = int(p.src[0])
            assert outs[i].tobytes() == b"ABCDEFGH"[s:s + 4]


def test_zero_task_nonempty_program_is_not_contiguous():
    from vcf2prot_tpu.runtime.pack import program_is_contiguous

    empty_ok = HaplotypeProgram(res_len=0, annotations=[])
    gap = HaplotypeProgram(res_len=3, annotations=[("T", 0, 3)])
    assert program_is_contiguous(empty_ok)
    assert not program_is_contiguous(gap)
    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    outs = DeviceEngine(blob).execute([gap, _mk_good("T", 0, 4)])
    assert outs[0].tobytes() == b"..."
    assert outs[1].tobytes() == b"ABCD"

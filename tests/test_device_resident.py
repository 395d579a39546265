"""Fully device-resident neoantigen path (downstream/device_resident.py) vs
the host-collection + batched-scoring path it must agree with.

The device path reformulates candidate collection as on-device masks (alt
detection via biased sources, window validity via span searchsorted) and
ranking as per-sample lax.top_k; these tests pin it row-for-row to the host
oracle chain on the same cohorts."""
import os

import numpy as np
import pytest

from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu.compiler.haplotype import (
    HaplotypeProgram,
    RefBlob,
    compile_haplotype,
)
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.downstream import cohort, device_resident
from vcf2prot_tpu.downstream.device_resident import (
    DeviceNeoantigenEngine,
    _chunk_annotation_spans,
    _host_chunk_rows,
    write_device_neoantigen_reports,
)
from vcf2prot_tpu.downstream.scoring import init_params
from vcf2prot_tpu.frontend.maps import group_muts_per_transcript
from vcf2prot_tpu.runtime.cpu_engine import execute_tasks


def build_cohort(seed=21, n_samples=3, n_transcripts=8):
    ref, samples = random_cohort(seed, n_samples, n_transcripts)
    blob = RefBlob.from_ref_seqs(ref)
    progs = []
    for h1, h2 in samples.values():
        for hap in (h1, h2):
            progs.append(
                compile_haplotype(
                    group_muts_per_transcript(hap), ref, blob, qc=QcConfig()
                )
            )
    return list(samples), progs, blob


def _assert_rows_match(dev_rows, host_rows):
    assert set(dev_rows) == set(host_rows)
    for i in dev_rows:
        d, h = dev_rows[i], host_rows[i]
        assert len(d) == len(h)
        for (ds, dh, dp, dw), (hs, hh, hp, hw) in zip(d, h):
            assert (dh, dp, dw) == (hh, hp, hw)
            np.testing.assert_allclose(ds, hs, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [21, 5, 13])
def test_run_chunk_matches_host_rows(seed):
    _names, progs, blob = build_cohort(seed=seed, n_samples=4)
    k = 9
    params = init_params(k)
    eng = DeviceNeoantigenEngine(blob, k, params=params, top=200)
    dev_rows = eng.run_chunk(progs)
    assert dev_rows is not None
    host_rows = _host_chunk_rows(progs, blob, k, params, 200)
    assert any(len(r) > 0 for r in dev_rows.values())
    _assert_rows_match(dev_rows, host_rows)


@pytest.mark.parametrize("k", [8, 10, 11])
def test_run_chunk_matches_host_rows_other_k(k):
    """MHC-I peptides span 8-11-mers; the chain must agree with the host
    oracle at every k in that range, not just the default 9."""
    _names, progs, blob = build_cohort(seed=21, n_samples=3)
    params = init_params(k)
    eng = DeviceNeoantigenEngine(blob, k, params=params, top=50)
    dev_rows = eng.run_chunk(progs)
    assert dev_rows is not None
    host_rows = _host_chunk_rows(progs, blob, k, params, 50)
    assert any(len(r) > 0 for r in dev_rows.values())
    _assert_rows_match(dev_rows, host_rows)


def test_run_chunk_matches_host_rows_nondefault_head():
    """Row agreement must hold at non-default head sizes (wider + deeper):
    the device chain's scoring is size-generic, not pinned to the 32x128
    scaffold (ARCHITECTURE 2.6 head-size sweep)."""
    _names, progs, blob = build_cohort(seed=5, n_samples=3)
    k = 9
    params = init_params(k, embed_dim=16, hidden=96, depth=2, seed=11)
    eng = DeviceNeoantigenEngine(blob, k, params=params, top=50)
    dev_rows = eng.run_chunk(progs)
    assert dev_rows is not None
    host_rows = _host_chunk_rows(progs, blob, k, params, 50)
    assert any(len(r) > 0 for r in dev_rows.values())
    _assert_rows_match(dev_rows, host_rows)


def test_run_chunk_top_truncation():
    _names, progs, blob = build_cohort(seed=9, n_samples=2)
    k = 9
    params = init_params(k)
    top = 3
    dev_rows = DeviceNeoantigenEngine(blob, k, params=params, top=top).run_chunk(
        progs
    )
    host_rows = _host_chunk_rows(progs, blob, k, params, top)
    assert all(len(r) <= top for r in dev_rows.values())
    _assert_rows_match(dev_rows, host_rows)


def test_device_reports_match_cohort_path(tmp_path):
    names, progs, blob = build_cohort(seed=7, n_samples=3)
    k = 9
    tapes = [execute_tasks(p, blob) for p in progs]
    a = tmp_path / "host"
    b = tmp_path / "device"
    a.mkdir()
    b.mkdir()
    cohort.write_cohort_neoantigen_reports(str(a), names, progs, tapes, k)
    write_device_neoantigen_reports(str(b), names, progs, blob, k)
    for name in names:
        fa = (a / f"{name}.neoantigens.tsv").read_text().splitlines()
        fb = (b / f"{name}.neoantigens.tsv").read_text().splitlines()
        assert fa[0] == fb[0]
        # identical candidate rows in identical rank order; scores agree to
        # float tolerance (different pad shapes around the same scorer)
        assert [l.split("\t")[:4] for l in fa[1:]] == [
            l.split("\t")[:4] for l in fb[1:]
        ]
        for la, lb in zip(fa[1:], fb[1:]):
            np.testing.assert_allclose(
                float(la.rsplit("\t", 1)[1]),
                float(lb.rsplit("\t", 1)[1]),
                rtol=1e-5, atol=1e-6,
            )


def test_device_reports_chunked_across_samples(tmp_path):
    """A chunk budget that splits the cohort sample-by-sample must produce
    the same files as one big chunk."""
    names, progs, blob = build_cohort(seed=11, n_samples=4)
    k = 9
    a = tmp_path / "one"
    b = tmp_path / "many"
    a.mkdir()
    b.mkdir()
    write_device_neoantigen_reports(str(a), names, progs, blob, k)
    write_device_neoantigen_reports(
        str(b), names, progs, blob, k, chunk_res_bytes=1
    )
    for name in names:
        assert (
            (a / f"{name}.neoantigens.tsv").read_text()
            == (b / f"{name}.neoantigens.tsv").read_text()
        )


def test_multi_chunk_run_presents_one_shape_set(tmp_path, monkeypatch):
    """A multi-chunk cohort must present exactly ONE input-shape tuple to
    each jitted device function: distinct shapes retrace and recompile. The
    run-wide Buckets folding guarantees at most one compile per function
    per run."""
    import jax.tree_util as jtu

    names, progs, blob = build_cohort(seed=11, n_samples=4)
    shapes = {"dense": set(), "aligned": set(), "compact": set(),
              "rank": set()}

    def spy(factory, key):
        def make(*fargs):
            fn = factory(*fargs)

            def run(*args):
                shapes[key].add(
                    (fargs, str(jtu.tree_map(lambda x: np.shape(x), args)))
                )
                return fn(*args)

            return run

        return make

    for attr, key in (("_dense_fn", "dense"),
                      ("_dense_fn_aligned", "aligned"),
                      ("_compact_fn", "compact"),
                      ("_rank_fn", "rank")):
        monkeypatch.setattr(
            device_resident, attr, spy(getattr(device_resident, attr), key)
        )
    write_device_neoantigen_reports(
        str(tmp_path), names, progs, blob, 9, chunk_res_bytes=1
    )
    # exactly ONE execute-path shape set across all chunks, whichever
    # gated path (byte, aligned, compact) the run takes
    exec_shapes = shapes["dense"] | shapes["aligned"] | shapes["compact"]
    assert len(exec_shapes) == 1, exec_shapes
    assert len(shapes["rank"]) == 1, shapes["rank"]


def test_pack_unpack_rows_roundtrip():
    """The single-fetch packing (scores f32 + positions i32 + peptide bytes
    bitcast into one u8 buffer) must round-trip exactly, including -inf
    scores and high byte values."""
    import jax.numpy as jnp

    from vcf2prot_tpu.downstream.device_resident import (
        _pack_rows,
        _unpack_rows,
    )

    rng = np.random.default_rng(3)
    vals = rng.standard_normal((4, 7)).astype(np.float32)
    vals[0, 3] = -np.inf
    gpos = rng.integers(0, 2**31 - 1, size=(4, 7)).astype(np.int32)
    wins = rng.integers(0, 256, size=(4, 7, 9)).astype(np.uint8)
    buf = np.asarray(
        _pack_rows(jnp, jnp.asarray(vals), jnp.asarray(gpos),
                   jnp.asarray(wins))
    )
    assert buf.shape == (4, 7, 8 + 9) and buf.dtype == np.uint8
    v2, g2, w2 = _unpack_rows(buf)
    np.testing.assert_array_equal(v2, vals)
    np.testing.assert_array_equal(g2, gpos)
    np.testing.assert_array_equal(w2, wins)


def test_interleaved_dispatch_collect_matches_sequential():
    """The writer's double-buffer dispatches chunk N+1 before collecting
    chunk N; two in-flight chunks must decode to exactly the sequential
    run_chunk rows (no shared mutable state between handles)."""
    _names, progs, blob = build_cohort(seed=13, n_samples=4)
    k = 9
    params = init_params(k)
    eng = DeviceNeoantigenEngine(blob, k, params=params, top=50)
    a, b = progs[:4], progs[4:]
    from vcf2prot_tpu.downstream.device_resident import run_buckets

    buckets = run_buckets(progs, [[0, 1, 2, 3], [4, 5, 6, 7]])
    h_a = eng.dispatch(a, buckets=buckets)
    h_b = eng.dispatch(b, buckets=buckets)  # both in flight
    rows_a, rows_b = eng.collect(h_a), eng.collect(h_b)
    eng2 = DeviceNeoantigenEngine(blob, k, params=params, top=50)
    _assert_rows_match(rows_a, eng2.run_chunk(a, buckets=buckets))
    _assert_rows_match(rows_b, eng2.run_chunk(b, buckets=buckets))


def test_non_contiguous_chunk_returns_none():
    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    bad = HaplotypeProgram(
        exe=np.array([0, 0], np.uint8),
        src=np.array([0, 4], np.int64),
        length=np.array([2, 2], np.int64),
        dst=np.array([0, 5], np.int64),  # gap -> pack is non-contiguous
        alt=b"",
        res_len=7,
        annotations=[("T", 0, 7)],
    )
    eng = DeviceNeoantigenEngine(blob, 3)
    assert eng.run_chunk([bad, bad]) is None


def test_non_tiling_annotations_return_none():
    blob = RefBlob.from_ref_seqs({"T": "ABCDEFGH"})
    prog = HaplotypeProgram(
        exe=np.array([0], np.uint8),
        src=np.array([0], np.int64),
        length=np.array([8], np.int64),
        dst=np.array([0], np.int64),
        alt=b"",
        res_len=8,
        annotations=[("T", 0, 4), ("U", 5, 8)],  # hole at byte 4
    )
    packed_spans = [(0, 0, 8), (1, 8, 16)]
    assert _chunk_annotation_spans([prog, prog], packed_spans) is None
    assert DeviceNeoantigenEngine(blob, 3).run_chunk([prog, prog]) is None


def test_fallback_writes_match_host(tmp_path, monkeypatch):
    """When run_chunk declines (malformed pack), the writer's host fallback
    must produce exactly the host-cohort files."""
    names, progs, blob = build_cohort(seed=3, n_samples=2)
    k = 9
    from vcf2prot_tpu.downstream.device_resident import ChunkHandle

    monkeypatch.setattr(
        DeviceNeoantigenEngine, "dispatch",
        lambda self, progs, buckets=None: ChunkHandle(
            "host", len(progs) // 2, None, None, None
        ),
    )
    a = tmp_path / "host"
    b = tmp_path / "fallback"
    a.mkdir()
    b.mkdir()
    tapes = [execute_tasks(p, blob) for p in progs]
    cohort.write_cohort_neoantigen_reports(str(a), names, progs, tapes, k)
    reports = write_device_neoantigen_reports(str(b), names, progs, blob, k)
    assert reports.host_chunks == 1
    for name in names:
        fa = (a / f"{name}.neoantigens.tsv").read_text().splitlines()
        fb = (b / f"{name}.neoantigens.tsv").read_text().splitlines()
        assert [l.split("\t")[:4] for l in fa] == [
            l.split("\t")[:4] for l in fb
        ]


def test_no_candidates_writes_header_only(tmp_path):
    names, progs, blob = build_cohort(seed=21, n_samples=2)
    # k longer than any transcript span -> zero valid windows
    k = 100_000
    paths, host_chunks = write_device_neoantigen_reports(
        str(tmp_path), names, progs, blob, k
    )
    assert host_chunks == 0
    assert len(paths) == len(names)
    for p in paths:
        lines = open(p).read().splitlines()
        assert lines == [
            "peptide\thaplotype\ttranscript\tprotein_start\tscore"
        ]


def test_cli_neoantigen_only_end_to_end(tmp_path, monkeypatch):
    """--neoantigen_only -g gpu (the GPU check passed over, so the device
    engine runs on the CPU backend): no FASTAs, TSVs match the host cohort
    run."""
    import jax

    from vcf2prot_tpu import cli
    from vcf2prot_tpu.cli import main

    monkeypatch.setattr(cli, "require_gpu", lambda: jax.devices()[0])

    ref, samples = random_cohort(seed=9, n_samples=2, n_transcripts=6)
    vcf = tmp_path / "c.vcf"
    fa = tmp_path / "r.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fa), ref)
    out_dev, out_host = tmp_path / "dev", tmp_path / "host"
    out_dev.mkdir()
    out_host.mkdir()
    base = ["-f", str(vcf), "-r", str(fa), "--neoantigen_k", "9"]
    assert main(
        base + ["-o", str(out_dev), "-g", "gpu", "--neoantigen_only"]
    ) == 0
    assert not any(f.endswith(".fasta") for f in os.listdir(out_dev))
    assert main(
        base + ["-o", str(out_host), "-g", "mt", "--neoantigen_device"]
    ) == 0
    for name in samples:
        dev = (out_dev / f"{name}.neoantigens.tsv").read_text().splitlines()
        host = (out_host / f"{name}.neoantigens.tsv").read_text().splitlines()
        assert [l.split("\t")[:4] for l in dev] == [
            l.split("\t")[:4] for l in host
        ]


def test_cli_neoantigen_only_requires_k(tmp_path):
    from vcf2prot_tpu.cli import main

    ref, samples = random_cohort(seed=9, n_samples=1, n_transcripts=3)
    vcf = tmp_path / "c.vcf"
    fa = tmp_path / "r.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fa), ref)
    with pytest.raises(SystemExit):
        main(
            ["-f", str(vcf), "-r", str(fa), "-o", str(tmp_path),
             "--neoantigen_only"]
        )

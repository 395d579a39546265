"""Native (C++) frontend/compiler parity against the Python oracle path.

The native module must produce identical task programs and, after execution,
byte-identical haplotype tapes for randomized cohorts.
"""
import numpy as np
import pytest

from genvcf import random_cohort, write_fasta, write_synthetic_vcf
from vcf2prot_tpu.compiler.haplotype import RefBlob
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.native_bridge import compile_cohort_native, load_native
from vcf2prot_tpu.pipeline import parse_vcf_to_int_maps
from vcf2prot_tpu.compiler.proband import compile_proband
from vcf2prot_tpu.runtime.cpu_engine import execute_tasks

pytestmark = pytest.mark.skipif(
    load_native() is None, reason="native module unavailable"
)

QC = QcConfig()


def build_cohort_files(tmp_path, seed, n_samples=6, n_transcripts=12):
    ref, samples = random_cohort(seed, n_samples, n_transcripts)
    vcf = tmp_path / "cohort.vcf"
    fasta = tmp_path / "ref.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fasta), ref)
    return ref, str(vcf)


@pytest.mark.parametrize("seed", [0, 1, 5, 11, 42])
def test_native_matches_python_path(seed, tmp_path):
    ref, vcf = build_cohort_files(tmp_path, seed)
    blob = RefBlob.from_ref_seqs(ref)

    # python oracle path
    int_maps = parse_vcf_to_int_maps(vcf)
    cache = {}
    py_programs = []
    py_probands = []
    for m in int_maps:
        pp = compile_proband(m, ref, blob, QC, cache)
        py_probands.append(pp.proband)
        py_programs.extend([pp.hap1, pp.hap2])

    # native path
    nat = compile_cohort_native(vcf, ref, blob, QC)
    assert nat is not None
    probands, nat_programs, warnings = nat
    assert probands == py_probands
    assert len(nat_programs) == len(py_programs)
    for i, (a, b) in enumerate(zip(py_programs, nat_programs)):
        assert a.res_len == b.res_len, f"hap {i}: res_len mismatch"
        assert a.annotations == b.annotations, f"hap {i}: annotations mismatch"
        np.testing.assert_array_equal(a.exe, b.exe, err_msg=f"hap {i} exe")
        np.testing.assert_array_equal(a.src, b.src, err_msg=f"hap {i} src")
        np.testing.assert_array_equal(a.length, b.length, err_msg=f"hap {i} len")
        np.testing.assert_array_equal(a.dst, b.dst, err_msg=f"hap {i} dst")
        assert a.alt == b.alt, f"hap {i}: alt tape mismatch"
        np.testing.assert_array_equal(
            execute_tasks(a, blob), execute_tasks(b, blob),
            err_msg=f"hap {i} executed output",
        )


def test_native_translation_cases(tmp_path):
    """The MAD1L1 translation fixtures through the native path end-to-end."""
    from fixtures import MAD1L1_FULL

    ref = {"ENST00000406869": MAD1L1_FULL}
    muts = [
        "missense|MAD1L1|ENST00000406869|protein_coding|-|666K>666N|1898200C>G",
        "inframe_insertion|MAD1L1|ENST00000406869|protein_coding|-|190L>190KQEL|2219360G>GCTCCTGCT",
    ]
    vcf = tmp_path / "one.vcf"
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1",
        "1\t100\tv1\tA\tT\t9\tPASS\tBCSQ=" + ",".join(muts) + "\tGT:BCSQ\t0|1:5",
    ]
    vcf.write_text("\n".join(lines) + "\n")
    blob = RefBlob.from_ref_seqs(ref)
    probands, programs, _w = compile_cohort_native(str(vcf), ref, blob, QC)
    assert probands == ["S1"]
    out = execute_tasks(programs[0], blob).tobytes().decode()
    assert len(out) == 721
    assert out[668] == "N"
    assert programs[1].res_len == 0


def test_native_stats_match_python_stats(tmp_path):
    """The native stats blocks must reproduce the Python stats engine."""
    from genvcf import write_fasta, write_synthetic_vcf
    from vcf2prot_tpu.native_bridge import compile_cohort_native
    from vcf2prot_tpu.stats.native_stats import stats_from_native
    from vcf2prot_tpu.stats.summary import compute_stats

    ref, samples = random_cohort(seed=31, n_samples=5, n_transcripts=9)
    vcf = tmp_path / "c.vcf"
    fasta = tmp_path / "r.fasta"
    write_synthetic_vcf(str(vcf), ref, samples)
    write_fasta(str(fasta), ref)
    blob = RefBlob.from_ref_seqs(ref)
    nat = compile_cohort_native(str(vcf), ref, blob, QC, collect_stats=True)
    probands, _programs, _warnings, blocks = nat
    n_pp, n_pt, n_tc = stats_from_native(probands, blocks)
    int_maps = parse_vcf_to_int_maps(str(vcf))
    p_pp, p_pt, p_tc = compute_stats(int_maps)
    assert n_pp == p_pp
    assert n_pt == p_pt
    assert n_tc == p_tc


def _assert_programs_equal(a, b, tag=""):
    assert a.res_len == b.res_len, tag
    assert a.annotations == b.annotations, tag
    np.testing.assert_array_equal(a.exe, b.exe, err_msg=tag)
    np.testing.assert_array_equal(a.src, b.src, err_msg=tag)
    np.testing.assert_array_equal(a.length, b.length, err_msg=tag)
    np.testing.assert_array_equal(a.dst, b.dst, err_msg=tag)
    assert a.alt == b.alt, tag


@pytest.mark.parametrize("seed", [2, 7])
def test_native_sample_subset_matches_filtered_full(seed, tmp_path):
    """Sharded decode+compile (sample_subset) must equal compiling the full
    cohort and filtering -- for text VCF, every shard layout, stats on."""
    ref, vcf = build_cohort_files(tmp_path, seed, n_samples=7)
    blob = RefBlob.from_ref_seqs(ref)
    full = compile_cohort_native(vcf, ref, blob, QC, collect_stats=True)
    probands, programs, _w, blocks = full

    for subset in ([0], [6], [1, 3, 5], [0, 2, 4, 6], list(range(7))):
        got = compile_cohort_native(
            vcf, ref, blob, QC, collect_stats=True, sample_subset=subset
        )
        g_probands, g_programs, _gw, g_blocks = got
        assert g_probands == [probands[i] for i in subset]
        assert len(g_programs) == 2 * len(subset)
        for j, i in enumerate(subset):
            for h in (0, 1):
                _assert_programs_equal(
                    programs[2 * i + h], g_programs[2 * j + h],
                    tag=f"subset={subset} sample {i} hap {h}",
                )
                assert g_blocks[2 * j + h] == blocks[2 * i + h]


def test_native_sample_subset_unsorted_and_bcf(tmp_path):
    """Unsorted/duplicated subsets normalize to cohort order; the BCF decode
    path honors the subset identically to the text path."""
    from genbcf import write_synthetic_bcf

    ref, samples = random_cohort(seed=3, n_samples=5, n_transcripts=12)
    vcf = str(tmp_path / "cohort.vcf")
    write_synthetic_vcf(vcf, ref, samples)
    blob = RefBlob.from_ref_seqs(ref)
    probands, programs, _w = compile_cohort_native(vcf, ref, blob, QC)

    got = compile_cohort_native(
        vcf, ref, blob, QC, sample_subset=[4, 1, 4, 1]
    )
    assert got[0] == [probands[1], probands[4]]
    for j, i in enumerate((1, 4)):
        for h in (0, 1):
            _assert_programs_equal(programs[2 * i + h], got[1][2 * j + h])

    bcf = str(tmp_path / "cohort.bcf")
    write_synthetic_bcf(bcf, ref, samples)
    full_bcf = compile_cohort_native(bcf, ref, blob, QC)
    got_bcf = compile_cohort_native(bcf, ref, blob, QC, sample_subset=[0, 2])
    assert got_bcf[0] == [full_bcf[0][0], full_bcf[0][2]]
    for j, i in enumerate((0, 2)):
        for h in (0, 1):
            _assert_programs_equal(
                full_bcf[1][2 * i + h], got_bcf[1][2 * j + h],
                tag=f"bcf sample {i} hap {h}",
            )

    with pytest.raises(RuntimeError, match="out of range"):
        compile_cohort_native(vcf, ref, blob, QC, sample_subset=[5])
    with pytest.raises(ValueError):
        compile_cohort_native(vcf, ref, blob, QC, sample_subset=[])


def test_shared_cohort_memo_matches_python_and_no_memo(tmp_path, monkeypatch):
    """1000G-like shared-variant cohort: the compile memo must stay enabled
    (high hit rate), and memo / no-memo / Python-oracle outputs must be
    array-identical."""
    from genvcf import shared_cohort

    ref, samples = shared_cohort(seed=9, n_samples=24, n_transcripts=10)
    vcf = tmp_path / "shared.vcf"
    write_synthetic_vcf(str(vcf), ref, samples)
    blob = RefBlob.from_ref_seqs(ref)

    nat = compile_cohort_native(str(vcf), ref, blob, QC)
    monkeypatch.setenv("VCF2PROT_NO_MEMO", "1")
    nat_nomemo = compile_cohort_native(str(vcf), ref, blob, QC)
    monkeypatch.delenv("VCF2PROT_NO_MEMO")

    int_maps = parse_vcf_to_int_maps(str(vcf))
    py_programs = []
    for m in int_maps:
        pp = compile_proband(m, ref, blob, QC, {})
        py_programs.extend([pp.hap1, pp.hap2])

    for tag, (probands, programs, _w) in (
        ("memo", nat), ("no-memo", nat_nomemo)
    ):
        assert len(programs) == len(py_programs)
        for i, (a, b) in enumerate(zip(py_programs, programs)):
            assert a.res_len == b.res_len, f"{tag} hap {i}"
            assert a.annotations == b.annotations, f"{tag} hap {i}"
            np.testing.assert_array_equal(a.exe, b.exe)
            np.testing.assert_array_equal(a.src, b.src)
            np.testing.assert_array_equal(a.length, b.length)
            np.testing.assert_array_equal(a.dst, b.dst)
            assert a.alt == b.alt, f"{tag} hap {i}: alt tape"


def test_empty_transcript_name_matches_python(tmp_path):
    """A parseable BCSQ entry whose transcript field is EMPTY must behave
    identically in both tiers: it groups under "" (not silently dropped),
    warns 'not in the reference', and is skipped — the round-4 decode-time
    name resolution must not conflate empty-name with parse-failure."""
    vcf = tmp_path / "empty_name.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        '##INFO=<ID=BCSQ,Number=.,Type=String,Description="csq">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\n"
        # entry 0: empty transcript name; entry 1: real transcript T0
        "1\t1000\t.\tA\tC\t.\t.\t"
        "BCSQ=missense|G||protein_coding|+|2K>2T|x,"
        "missense|G|T0|protein_coding|+|2K>2T|x\tGT:BCSQ\t1|0:5\n"
    )
    ref = {"T0": "MKLMNPQRST"}
    blob = RefBlob.from_ref_seqs(ref)
    int_maps = parse_vcf_to_int_maps(str(vcf))
    py_programs = []
    py_warnings = []
    import io
    from contextlib import redirect_stderr

    cache = {}
    buf = io.StringIO()
    with redirect_stderr(buf):
        for m in int_maps:
            pp = compile_proband(m, ref, blob, QC, cache)
            py_programs.extend([pp.hap1, pp.hap2])
    nat = compile_cohort_native(str(vcf), ref, blob, QC)
    assert nat is not None
    _probands, nat_programs, warnings = nat
    # the empty-named group must surface as a skip warning in BOTH tiers
    assert any("not in the reference" in w for w in warnings), warnings
    assert "not in the reference" in buf.getvalue()
    for a, b in zip(py_programs, nat_programs):
        assert a.res_len == b.res_len
        assert list(a.annotations) == list(b.annotations)
        np.testing.assert_array_equal(a.exe, b.exe)
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(
            execute_tasks(a, blob), execute_tasks(b, blob)
        )


def test_native_build_aligned_program_matches_numpy():
    """The native one-pass word-program builder must be array-equal to the
    numpy oracle (runtime/device_engine.build_aligned_program's int64 body)
    on real packed cohorts, including zero-length/coincident tasks and the
    end-of-tape demotion rule."""
    import numpy as np

    from test_device_resident import build_cohort
    from vcf2prot_tpu.native_bridge import load_native
    from vcf2prot_tpu.runtime.pack import pack_cohort, pad_to_bucket
    from vcf2prot_tpu.runtime.device_engine import build_aligned_program

    if load_native() is None or not hasattr(
        load_native(), "build_aligned_program"
    ):
        import pytest

        pytest.skip("native module unavailable")
    for seed in (3, 9, 21, 13):
        _n, progs, blob = build_cohort(seed=seed, n_samples=4)
        p = pack_cohort(progs, blob)
        cl = len(blob.data) + pad_to_bucket(max(len(p.alt), 1))
        nat = build_aligned_program(p.dst, p.src_biased, p.total_res, cl)
        ora = build_aligned_program(
            p.dst.astype(np.int64), p.src_biased.astype(np.int64),
            p.total_res, cl,
        )
        for a, b in zip(nat, ora):
            np.testing.assert_array_equal(
                np.asarray(a, np.int64), np.asarray(b, np.int64)
            )

"""End-to-end translation conformance: the reference's 30 "crown jewel" cases.

Each case compiles a transcript's mutation list against a real MAD1L1 protein
string, executes the Task program, and asserts the output sequence/length
(reference: transcript_instructions.rs:884-1594,
``test_correct_translation_1`` .. ``_30``).

Both host engines (serial task interpreter and the device gather formulation)
are asserted to agree on every case.
"""
import numpy as np
import pytest

from fixtures import FRAMESHIFT_29, MAD1L1_FULL, MAD1L1_SHORT
from vcf2prot_tpu.compiler.haplotype import RefBlob, compile_haplotype
from vcf2prot_tpu.compiler.qc import QC_OFF, QcConfig
from vcf2prot_tpu.frontend.maps import AltTranscript
from vcf2prot_tpu.runtime.cpu_engine import execute_gather, execute_tasks

TXP = "ENST00000406869"
QC_ON = QcConfig(debug_txp="")


def run_case(mutations, ref_seq=MAD1L1_SHORT, qc=QC_ON):
    """Compile + execute one transcript; returns the output string."""
    ref_seqs = {TXP: ref_seq}
    blob = RefBlob.from_ref_seqs(ref_seqs)
    at = AltTranscript.from_csq_strings(TXP, mutations)
    prog = compile_haplotype([at], ref_seqs, blob, qc=qc)
    out_serial = execute_tasks(prog, blob)
    out_gather = execute_gather(prog, blob)
    np.testing.assert_array_equal(out_serial, out_gather)
    return out_serial.tobytes().decode("ascii")


def check_mismatch_only_at(ref, res, indices):
    assert len(ref) == len(res)
    for i, (a, b) in enumerate(zip(ref, res)):
        if i not in indices:
            assert a == b, f"mismatch at {i}: {a} != {b}"


def csq(kind, change):
    return f"{kind}|MAD1L1|{TXP}|protein_coding|-|{change}|1936821C>T"


def test_translation_1():
    res = run_case([csq("*missense", "5G>5H")])
    check_mismatch_only_at(MAD1L1_SHORT, res, {4})
    assert res[4] == "H"


def test_translation_2():
    res = run_case([csq("*missense", "10V>10H")])
    check_mismatch_only_at(MAD1L1_SHORT, res, {9})


def test_translation_3():
    res = run_case([csq("*missense", "10V>10H"), csq("*missense", "20F>20K")])
    assert len(res) == len(MAD1L1_SHORT)
    check_mismatch_only_at(MAD1L1_SHORT, res, {9, 19})


def test_translation_4():
    res = run_case([
        csq("*missense", "5G>5T"),
        csq("*missense", "10V>10E"),
        csq("*missense", "15R>15S"),
        csq("*missense", "20F>20T"),
    ])
    assert len(res) == len(MAD1L1_SHORT)
    check_mismatch_only_at(MAD1L1_SHORT, res, {4, 9, 14, 19})
    assert res[4] == "T" and res[9] == "E" and res[14] == "S" and res[19] == "T"


def test_translation_5():
    res = run_case([csq("inframe_insertion", "5G>5GTEST")])
    assert len(res) == len(MAD1L1_SHORT) + 4
    assert res == MAD1L1_SHORT[:5] + "TEST" + MAD1L1_SHORT[5:]


def test_translation_6():
    res = run_case([
        csq("inframe_insertion", "5G>5GTEST"),
        csq("inframe_insertion", "10V>10VECT"),
    ])
    assert len(res) == len(MAD1L1_SHORT) + 7
    assert res == MAD1L1_SHORT[:5] + "TEST" + MAD1L1_SHORT[5:10] + "ECT" + MAD1L1_SHORT[10:]


def test_translation_7():
    res = run_case([
        csq("inframe_insertion", "5G>5GTEST"),
        csq("inframe_insertion", "10V>10VECT"),
        csq("inframe_insertion", "14R>14RAPID"),
    ])
    assert len(res) == len(MAD1L1_SHORT) + 11


def test_translation_8():
    res = run_case([csq("frameshift", "10V>10VTESTFRAMESHIFT")])
    assert len(res) == 24
    assert res == MAD1L1_SHORT[:9] + "VTESTFRAMESHIFT"


def test_translation_9():
    res = run_case([csq("inframe_deletion", "10VLSTLR>10V")])
    assert len(res) == 33
    assert res == MAD1L1_SHORT[:10] + MAD1L1_SHORT[15:]


def test_translation_10():
    res = run_case([csq("inframe_deletion", "10VLSTLR>10R")])
    assert len(res) == 33


def test_translation_11():
    res = run_case([
        csq("inframe_deletion", "10VLSTLR>10R"),
        csq("inframe_deletion", "28GSGLE>28E"),
    ])
    assert len(res) == 29


def test_translation_12():
    res = run_case([csq("stop_gained", "37G>37*")])
    assert len(res) == 36
    assert res == MAD1L1_SHORT[:36]


def test_translation_13():
    res = run_case([csq("stop_lost", "39*>39TEST")])
    assert len(res) == 42
    assert res == MAD1L1_SHORT + "TEST"


def test_translation_14():
    res = run_case([csq("stop_lost", "38G*>39TEST")])
    assert len(res) == 42
    assert res == MAD1L1_SHORT + "TEST"


def test_translation_15():
    res = run_case([csq("*missense&inframe_altering", "34LERGG>34LTEST")])
    assert len(res) == 38
    assert res == MAD1L1_SHORT[:33] + "LTEST"


def test_translation_16():
    res = run_case([
        csq("*frameshift&stop_retained", "20FISQRVEGGSGLEELERGG*>20LTEST*")
    ])
    assert len(res) == 24
    assert res == MAD1L1_SHORT[:19] + "LTEST"


def test_translation_17():
    res = run_case([
        csq("*frameshift&stop_retained", "20FISQRVEGGSGLEELERGG*>20TEST")
    ])
    assert len(res) == 23
    assert res == MAD1L1_SHORT[:19] + "TEST"


def test_translation_18():
    res = run_case([
        csq("*stop_gained&inframe_altering", "20FISQRVEGGSGLEELERGG*>20")
    ])
    assert len(res) == 19
    assert res == MAD1L1_SHORT[:19]


def test_translation_19():
    res = run_case([
        csq("frameshift&stop_retained", "20FISQRVEGGSGLEELERGG*>20FLTESTTWO*")
    ])
    assert len(res) == 28
    assert res == MAD1L1_SHORT[:19] + "FLTESTTWO"


def test_translation_20():
    # 'P' with a non-'*'-terminated ref side under-covers the tape; the
    # reference exposes its '.' prefill at the final position (QC off there).
    res = run_case([csq("inframe_deletion&stop_retained", "38*>38*")], qc=QC_OFF)
    assert len(res) == 38
    assert res == MAD1L1_SHORT[:37] + "."


def test_translation_21():
    res = run_case([csq("inframe_insertion&stop_retained", "38*>38*")], qc=QC_OFF)
    # all-phi transcript: the reference keeps the transcript with an
    # *erased* (empty) annotation? No -- a transcript whose instructions are
    # all phi fails compilation and is skipped; the haplotype then has no
    # annotated span. The reference test asserts against its preallocated
    # buffer; the observable FASTA output contains nothing for it.
    assert res == ""


def test_translation_22():
    res = run_case([
        csq("stop_gained&inframe_altering", "20FISQRVEGGSGLEELERGG*>20*")
    ])
    assert len(res) == 19
    assert res == MAD1L1_SHORT[:19]


def test_translation_23():
    res = run_case([csq("stop_lost&frameshift", "39*>39TEST")])
    assert len(res) == 42
    assert res == MAD1L1_SHORT + "TEST"


def test_translation_24():
    res = run_case([csq("missense&inframe_altering", "34ERGG>34YEAP")])
    assert len(res) == 38
    # '2' replaces 4 residues at 0-based 33; the tail copy resumes at 37
    assert res == MAD1L1_SHORT[:33] + "YEAP" + MAD1L1_SHORT[37:]


MIXED = [
    "missense|MAD1L1|ENST00000265854|protein_coding|-|710E>710K|1816099C>T",
    "missense|MAD1L1|ENST00000399654|protein_coding|-|706S>706L|1816110G>A",
    "missense|MAD1L1|ENST00000265854|protein_coding|-|696R>696L|1816140C>A",
    "missense|MAD1L1|ENST00000406869|protein_coding|-|666K>666N|1898200C>G",
    "missense|MAD1L1|ENST00000265854|protein_coding|-|650R>650Q|1898249C>T",
    "inframe_insertion|MAD1L1|ENST00000455998|protein_coding|-|143L>143KQEL|2219360G>GCTCCTGCTT",
]


def test_translation_25():
    res = run_case(MIXED, ref_seq=MAD1L1_FULL)
    assert len(res) == 721
    assert res[712] == "K"
    assert res[708] == "L"
    assert res[698] == "L"
    assert res[668] == "N"
    assert res[652] == "Q"


def test_translation_26():
    muts = MIXED + [
        "inframe_insertion|MAD1L1|ENST00000406869|protein_coding|-|190L>190KQEL|2219360G>GCTCCTGCT",
    ]
    res = run_case(muts, ref_seq=MAD1L1_FULL)
    assert len(res) == 724
    assert res[715] == "K"
    assert res[711] == "L"
    assert res[701] == "L"
    assert res[671] == "N"
    assert res[655] == "Q"


def test_translation_27():
    muts = MIXED + [
        "inframe_insertion|MAD1L1|ENST00000406869|protein_coding|-|190L>190KQEL|2219360G>GCTCCTGCT",
        "inframe_deletion|MAD1L1|ENST00000399654|protein_coding|-|661DCL>661L|1898211GGCAGTC>G",
    ]
    res = run_case(muts, ref_seq=MAD1L1_FULL)
    assert len(res) == 722
    assert res[713] == "K"
    assert res[709] == "L"
    assert res[699] == "L"
    assert res[669] == "N"
    assert res[655] == "Q"


def test_translation_28():
    muts = MIXED + [
        "inframe_insertion|MAD1L1|ENST00000406869|protein_coding|-|190L>190KQEL|2219360G>GCTCCTGCT",
        "inframe_deletion|MAD1L1|ENST00000437877|protein_coding|-|117DCL>117L|1898211GGCAGTC>G",
        "inframe_deletion|MAD1L1|ENST00000399654|protein_coding|-|661DCL>661L|1898211GGCAGTC>G",
    ]
    res = run_case(muts, ref_seq=MAD1L1_FULL)
    assert len(res) == 720
    assert res[711] == "K"
    assert res[707] == "L"
    assert res[697] == "L"
    assert res[667] == "N"
    assert res[653] == "Q"


def test_translation_29():
    res = run_case([FRAMESHIFT_29], ref_seq=MAD1L1_FULL)
    assert len(res) == 340
    assert res == MAD1L1_FULL[:318] + "GETGPDHGPEHQDSRRPFQIRG"


def test_translation_30():
    res = run_case(
        ["stop_gained|MAD1L1|ENST00000406869|protein_coding|-|82R>82*|2225457G>A"],
        ref_seq=MAD1L1_FULL,
    )
    assert len(res) == 81
    assert res == MAD1L1_FULL[:81]


def test_expected_result_array_length():
    # transcript_instructions.rs:790-804
    from vcf2prot_tpu.compiler import instruction as ins_mod
    from vcf2prot_tpu.compiler.transcript import (
        TranscriptInstruction,
        compute_expected_results_array_size,
    )
    from vcf2prot_tpu.frontend.mutation import Mutation

    prev = Mutation.from_fields(["missense", "ENST00000510017", "40V>40N"])
    m = Mutation.from_fields(
        ["frameshift", "ENST00000510017", "40VGLHFWTM*>40VDSTFGQC"]
    )
    ins = ins_mod.from_mutation(m, [prev])
    t = TranscriptInstruction("Test1", 50, [ins])
    assert compute_expected_results_array_size(t) == 47

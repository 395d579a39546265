"""Executor edge shapes: zero-length tasks, empty programs, single-byte
interleavings -- gather formulation vs serial oracle."""
import numpy as np

from vcf2prot_tpu.compiler.haplotype import HaplotypeProgram, RefBlob
from vcf2prot_tpu.runtime.cpu_engine import execute_gather, execute_tasks
from vcf2prot_tpu.runtime.device_engine import DeviceEngine


def mk_prog(tasks, alt, res_len, ann=()):
    exe = np.array([t[0] for t in tasks], dtype=np.uint8)
    src = np.array([t[1] for t in tasks], dtype=np.int64)
    length = np.array([t[2] for t in tasks], dtype=np.int64)
    dst = np.array([t[3] for t in tasks], dtype=np.int64)
    return HaplotypeProgram(exe, src, length, dst, alt, res_len, list(ann))


BLOB = RefBlob.from_ref_seqs({"T": "ABCDEFGHIJKLMNOP"})


def assert_all_engines(prog, expected):
    serial = execute_tasks(prog, BLOB)
    assert serial.tobytes() == expected
    gather = execute_gather(prog, BLOB)
    np.testing.assert_array_equal(serial, gather)
    dev = DeviceEngine(BLOB)
    outs = dev.execute([prog])
    np.testing.assert_array_equal(serial, outs[0])


def test_zero_length_leading_task():
    # base copy of length 0 followed by real tasks
    prog = mk_prog(
        [(0, 0, 0, 0), (1, 0, 2, 0), (0, 2, 3, 2)], b"xy", 5
    )
    assert_all_engines(prog, b"xyCDE")


def test_interleaved_single_bytes():
    tasks = []
    alt = b"zzzzzzzz"
    for i in range(8):
        tasks.append((i % 2, i, 1, i))
    prog = mk_prog(tasks, alt, 8)
    assert_all_engines(prog, b"AzCzEzGz")


def test_empty_program():
    prog = mk_prog([], b"", 0)
    assert_all_engines(prog, b"")


def test_zero_length_between_tasks():
    prog = mk_prog(
        [(0, 0, 2, 0), (1, 0, 0, 2), (0, 5, 2, 2)], b"q", 4
    )
    assert_all_engines(prog, b"ABFG")


# ---- word-aligned production kernel (runtime/device_engine.build_aligned_program)
# The gate is out_bucket >= 1024, so these cases pad the tape past it to
# exercise the aligned path specifically (the small cases above take the
# delta fallback). Every case is also checked with the fallback forced.


def assert_aligned_and_delta(prog, monkeypatch=None):
    import os

    serial = execute_tasks(prog, BLOB)
    aligned = DeviceEngine(BLOB).execute([prog])[0]
    np.testing.assert_array_equal(serial, aligned)
    os.environ["VCF2PROT_ALIGNED_EXEC"] = "0"
    try:
        delta = DeviceEngine(BLOB).execute([prog])[0]
    finally:
        del os.environ["VCF2PROT_ALIGNED_EXEC"]
    np.testing.assert_array_equal(serial, delta)


def _pad_tasks(tasks, alt, res_len, target=1200):
    """Append a trailing ref copy so the bucket crosses the aligned gate."""
    blob_len = len(BLOB.data)
    need = target - res_len
    out = list(tasks)
    pos = res_len
    while need > 0:
        n = min(need, blob_len)
        out.append((0, 0, n, pos))
        pos += n
        need -= n
    return out, alt, pos


def test_aligned_zero_length_and_interleaved():
    tasks = [(0, 0, 0, 0), (1, 0, 2, 0), (0, 2, 3, 2), (1, 2, 0, 5)]
    for i in range(8):
        tasks.append((i % 2, i, 1, 5 + i))
    tasks, alt, res = _pad_tasks(tasks, b"xyzzzzzzzz", 13)
    prog = mk_prog(tasks, alt, res)
    assert_aligned_and_delta(prog)


def test_aligned_source_near_combined_end():
    """Tasks whose source span ends within 8 bytes of the combined tape are
    demoted to boundary bytes (the two-word load guard); the final output
    bytes must still be exact."""
    alt = b"0123456789"  # combined = blob(16) || padded alt
    tasks = [
        (1, 8, 2, 0),    # alt tail: source ends at the padded-alt boundary
        (0, 14, 2, 2),   # blob tail
        (1, 0, 10, 4),   # whole alt
    ]
    tasks, alt, res = _pad_tasks(tasks, alt, 14)
    prog = mk_prog(tasks, alt, res)
    assert_aligned_and_delta(prog)


def test_aligned_random_property():
    """Randomized task streams (mixed lengths incl. 0, ref/alt sources) vs
    the serial oracle, at aligned-path scale."""
    rng = np.random.default_rng(11)
    for case in range(6):
        alt = bytes(rng.integers(97, 123, size=64, dtype=np.uint8))
        tasks = []
        pos = 0
        while pos < 1500:
            ln = int(rng.choice([0, 1, 2, 3, 5, 9, 17, 40]))
            if rng.random() < 0.5:
                ln = min(ln, len(BLOB.data))
                src = int(rng.integers(0, len(BLOB.data) - ln + 1))
                tasks.append((0, src, ln, pos))
            else:
                ln = min(ln, len(alt))
                src = int(rng.integers(0, len(alt) - ln + 1))
                tasks.append((1, src, ln, pos))
            pos += ln
        prog = mk_prog(tasks, alt, pos)
        assert_aligned_and_delta(prog)

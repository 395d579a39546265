"""Device-resident downstream consumer: peptide-window enumeration.

Personalized proteomes exist to feed immunopeptidomics pipelines: enumerate
candidate MHC-presented peptides (k-mers, typically 8-11 residues) over each
personalized protein and rank the *neoantigen candidates* -- the peptides that
overlap a mutated residue. The reference stops at FASTA files on disk; this
module is why the device execution path is load-bearing: the executed
haplotype tape never leaves HBM, and the window tensors it produces are
shaped for a matmul-based peptide model (one-hot @ embedding).

All functions are jit-compatible with static shapes:

* ``peptide_windows``          -- every k-mer of a haplotype tape that does
  not span a transcript boundary;
* ``mutated_window_mask``      -- which windows overlap >= 1 alt-sourced byte
  (the neoantigen-candidate filter), computed from the task program itself
  via a prefix sum -- no re-alignment against the reference needed;
* ``encode_windows``           -- uint8 residues -> one-hot bf16, ready for
  ``windows_onehot @ embedding`` as one matmul.
"""
from __future__ import annotations

import numpy as np

# canonical residue alphabet for one-hot encoding (index 20 = other/'.')
ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


def _alphabet_lut() -> np.ndarray:
    lut = np.full(256, 20, dtype=np.int32)
    for i, c in enumerate(ALPHABET):
        lut[ord(c)] = i
    return lut


def valid_window_starts(annotations, tape_len: int, k: int) -> np.ndarray:
    """Boolean mask over tape positions: True where a k-mer starting there
    lies entirely inside one transcript's span.

    Segment arithmetic over the packed annotation arrays (spans tile the tape
    disjointly): +1/-1 boundary scatter, then a prefix sum -- O(spans + tape)
    with no per-annotation Python loop (at north-star scale a cohort carries
    3.5M spans)."""
    if hasattr(annotations, "starts"):
        starts = np.asarray(annotations.starts)
        ends = np.asarray(annotations.ends)
    else:  # plain (name, start, end) tuples (Python-tier tests, checkpoints)
        spans = [(s, e) for _n, s, e in annotations]
        starts = np.fromiter((s for s, _e in spans), np.int64, len(spans))
        ends = np.fromiter((e for _s, e in spans), np.int64, len(spans))
    keep = (ends - starts) >= k
    diff = np.zeros(tape_len + 1, dtype=np.int32)
    np.add.at(diff, starts[keep], 1)
    np.add.at(diff, ends[keep] - (k - 1), -1)
    return np.cumsum(diff[:-1], dtype=np.int32) > 0


def alt_byte_mask(prog, tape_len: int) -> np.ndarray:
    """Boolean mask of result-tape bytes carrying mutated residues, straight
    from the task program's exe==1 spans.

    Compiler '.' filler spans (under-covering opcodes expose the reference's
    prefill; transcript.py get_g_rep) are alt-sourced but are NOT mutations --
    they are excluded by checking the actual alt bytes. Gather/scatter index
    expansion (repeat + segment-local arange) over the selected spans -- no
    per-task Python loop.
    """
    mask = np.zeros(tape_len, dtype=bool)
    alt = prog.alt if isinstance(prog.alt, bytes) else prog.alt.encode("ascii")
    alt_arr = np.frombuffer(alt, dtype=np.uint8)
    sel = (np.asarray(prog.exe) == 1) & (np.asarray(prog.length) > 0)
    if not sel.any():
        return mask
    lens = np.asarray(prog.length)[sel]
    dsts = np.asarray(prog.dst)[sel]
    srcs = np.asarray(prog.src)[sel]
    # within-span offsets: arange(total) minus each span's flat start
    within = np.arange(int(lens.sum()), dtype=np.int64)
    within -= np.repeat(np.cumsum(lens) - lens, lens)
    mask[np.repeat(dsts, lens) + within] = (
        alt_arr[np.repeat(srcs, lens) + within] != ord(".")
    )
    return mask


def peptide_windows(tape, starts_mask, k: int):
    """All valid k-mer windows of a tape as a device array.

    ``tape`` uint8[n] (host or device), ``starts_mask`` bool[n]. Returns
    ``(windows u8[m, k], starts i32[m])`` where m is the number of valid
    starts -- note m is data-dependent, so this runs un-jitted at the
    boundary; the returned tensors have static shapes downstream.
    """
    import jax.numpy as jnp

    starts = np.nonzero(starts_mask)[0].astype(np.int32)
    tape_d = jnp.asarray(tape)
    starts_d = jnp.asarray(starts)
    idx = starts_d[:, None] + jnp.arange(k, dtype=jnp.int32)[None, :]
    return jnp.take(tape_d, idx), starts_d


def mutated_window_mask(alt_mask: np.ndarray, starts: np.ndarray, k: int):
    """True for windows overlapping at least one mutated byte (prefix-sum
    range query)."""
    import jax.numpy as jnp

    cum = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(jnp.asarray(alt_mask, jnp.int32))]
    )
    s = jnp.asarray(starts)
    return (cum[s + k] - cum[s]) > 0


def encode_windows(windows):
    """uint8 residue windows -> one-hot bfloat16 [m, k, 21] for matmuls.

    GATHER-FREE: the residue id is found by comparing each byte against the
    20 alphabet constants (one vectorized equality per class, 'other' = no
    match) instead of a 256-entry LUT take -- on the accelerator this was
    tuned on, the per-element LUT gather was the dominant cost of the whole
    scoring chain (not yet measured on the H100). Bit-identical to
    one_hot(lut[windows]): ALPHABET bytes are distinct, so exactly one
    class column (or 'other') is 1.
    """
    import jax.numpy as jnp

    ab = jnp.asarray(np.frombuffer(ALPHABET.encode(), np.uint8))
    eq = windows[..., None] == ab  # [m, k, 20]
    other = ~jnp.any(eq, axis=-1, keepdims=True)
    return jnp.concatenate([eq, other], axis=-1).astype(jnp.bfloat16)


def neoantigen_candidates(prog, tape, k: int = 9):
    """The end-to-end device query: all k-mers of a haplotype tape that
    contain at least one mutated residue, plus their start offsets.

    Returns ``(windows u8[m, k], starts i32[m])`` with m = number of
    mutation-overlapping windows. The tape and all intermediates stay on
    device; only the boolean masks are host-derived from the (host-resident)
    task program.
    """
    import numpy as np

    starts_mask = valid_window_starts(prog.annotations, prog.res_len, k)
    windows, starts = peptide_windows(tape, starts_mask, k)
    alt = alt_byte_mask(prog, prog.res_len)
    mutated = np.asarray(mutated_window_mask(alt, np.asarray(starts), k))
    keep = np.nonzero(mutated)[0]
    return windows[keep], starts[keep]

"""Peptide scoring head: a matmul-shaped model scaffold over peptide windows.

A production-shaped architecture for ranking neoantigen candidate peptides:
one-hot residues -> per-position embedding -> flatten -> a configurable
dense(relu) stack -> dense(1). Width (``embed_dim``, ``hidden``) and depth
are free parameters of ``init_params``; the default is a lightweight
scaffold; wider heads (e.g. 512x3) take the compacted device path.
Everything is bf16 with fp32 accumulation (``preferred_element_type``),
jit-compiled, and batched over windows -- the shape a real
MHC-presentation predictor takes on an accelerator.

The default parameters are deterministic random initialization: this is an
architecture scaffold to load trained weights into (``params`` is a plain
pytree), not a trained predictor -- scoring biology requires real weights.
"""
from __future__ import annotations

import numpy as np

from .peptides import ALPHABET, _alphabet_lut

VOCAB = len(ALPHABET) + 1  # + 'other'


def init_params(k: int = 9, embed_dim: int = 32, hidden=128,
                depth: int = 1, seed: int = 0) -> dict:
    """Deterministic He-style initialization of the scoring head.

    ``hidden`` is one width (int) or a per-layer width sequence; ``depth``
    repeats an int width that many times. The default (128x1) is the
    lightweight scaffold; production MHC-presentation predictors are
    wider/deeper -- the whole chain (host + device + training) accepts any
    (embed_dim, hidden, depth), see ARCHITECTURE 2.6's head-size sweep.
    """
    rng = np.random.default_rng(seed)

    def dense(n_in, n_out):
        w = rng.standard_normal((n_in, n_out)) * np.sqrt(2.0 / n_in)
        return w.astype(np.float32), np.zeros(n_out, dtype=np.float32)

    widths = list(hidden) if np.ndim(hidden) else [int(hidden)] * depth
    if not widths:
        raise ValueError("at least one hidden layer is required")
    embed = (rng.standard_normal((VOCAB, embed_dim)) * 0.1).astype(np.float32)
    params = {"embed": embed}
    n_in = k * embed_dim
    for i, width in enumerate(widths + [1], start=1):
        w, b = dense(n_in, width)
        params[f"w{i}"] = w
        params[f"b{i}"] = b
        n_in = width
    return params


def layer_names(params: dict) -> list:
    """Dense-layer weight keys in application order (``w1``..``wN``; the
    last is the [H, 1] output head)."""
    return sorted(
        (key for key in params if key[0] == "w" and key[1:].isdigit()),
        key=lambda key: int(key[1:]),
    )


def load_params(path: str, k: int) -> dict:
    """Load trained scoring-head weights from an ``.npz`` file.

    Expected arrays: ``embed [VOCAB, E]`` plus a dense stack ``w1 [k*E, H1]``,
    ``b1 [H1]``, ..., ``wN [H(N-1), 1]``, ``bN [1]`` for any depth N >= 2.
    Shapes are validated against ``k`` so a mismatched peptide length fails
    loudly at load time, not as a silent device-shape error mid-cohort.
    """
    data = np.load(path)
    if "embed" not in data.files:
        raise ValueError(f"scoring params {path} missing arrays: ['embed']")
    names = layer_names({name: None for name in data.files})
    if len(names) < 2 or names != [f"w{i}" for i in
                                   range(1, len(names) + 1)]:
        raise ValueError(
            f"scoring params {path} missing arrays: needs a contiguous "
            f"dense stack w1..wN (N >= 2); found {names}"
        )
    missing = {f"b{i}" for i in range(1, len(names) + 1)} - set(data.files)
    if missing:
        raise ValueError(
            f"scoring params {path} missing arrays: {sorted(missing)}"
        )
    params = {
        name: np.asarray(data[name], np.float32)
        for name in ["embed"]
        + [key for i in range(1, len(names) + 1) for key in (f"w{i}", f"b{i}")]
    }
    vocab, embed_dim = params["embed"].shape
    if vocab != VOCAB:
        raise ValueError(
            f"embed vocab {vocab} != expected {VOCAB} "
            f"(alphabet {ALPHABET!r} + other)"
        )
    n_in = k * embed_dim
    for i, name in enumerate(names, start=1):
        got_in, got_out = params[name].shape
        if got_in != n_in:
            if i == 1:
                raise ValueError(
                    f"w1 expects {got_in} inputs but k={k} x "
                    f"embed={embed_dim} gives {n_in}"
                )
            raise ValueError(
                f"{name} expects {got_in} inputs but the previous layer "
                f"emits {n_in}"
            )
        if params[f"b{i}"].shape != (got_out,):
            raise ValueError(f"b{i} shape disagrees with {name}")
        n_in = got_out
    if n_in != 1:
        raise ValueError("output head must be [H, 1] weights + [1] bias")
    return params


def score_windows(windows, params: dict):
    """Score uint8 residue windows [m, k]; returns fp32 scores [m].

    jit-compatible; all matmuls run bf16 with fp32 accumulation.
    The per-position embedding is FOLDED into the first dense layer: since
    both are linear, ``concat_i(onehot_i @ embed) @ w1`` equals
    ``onehot2 @ W`` with ``W[i*V:(i+1)*V] = embed @ w1[i*E:(i+1)*E]``. That
    turns the batch-dominant work into one [m, k*V] @ [k*V, H] matmul with a
    contraction axis the matrix units can tile (k*V = 225 for 9-mers),
    instead of a 25-deep einsum that underuses them; the fold itself is
    a tiny [V, E] x [k, E, H] contraction computed once per call in fp32.
    """
    import jax
    import jax.numpy as jnp

    from .peptides import encode_windows

    m, k = windows.shape
    names = layer_names(params)
    # gather-free one-hot (see encode_windows)
    onehot = encode_windows(windows).reshape(m, k * VOCAB)
    embed = jnp.asarray(params["embed"], jnp.float32)
    w1 = jnp.asarray(params[names[0]], jnp.float32)
    hidden = w1.shape[1]
    # HIGHEST: a GPU would otherwise run this fp32 contraction in TF32;
    # it is tiny, so full precision costs nothing
    folded = jnp.einsum(
        "ve,keh->kvh", embed, w1.reshape(k, embed.shape[1], hidden),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(k * VOCAB, hidden).astype(jnp.bfloat16)
    h = jnp.dot(onehot, folded, preferred_element_type=jnp.float32)
    h = jax.nn.relu(h + jnp.asarray(params["b1"]))
    for name in names[1:-1]:
        w = jnp.asarray(params[name], jnp.bfloat16)
        b = jnp.asarray(params["b" + name[1:]])
        h = jax.nn.relu(
            jnp.dot(h.astype(jnp.bfloat16), w,
                    preferred_element_type=jnp.float32) + b
        )
    w_out = jnp.asarray(params[names[-1]], jnp.bfloat16)
    out = jnp.dot(
        h.astype(jnp.bfloat16), w_out, preferred_element_type=jnp.float32
    )
    b_out = jnp.asarray(params["b" + names[-1][1:]])
    return (out[:, 0] + b_out[0]).astype(jnp.float32)


def rank_neoantigen_candidates(prog, tape, k: int = 9, params: dict = None,
                               top: int = 50):
    """End-to-end device query: mutated k-mers of a haplotype tape, scored
    and ranked. Returns ``(windows u8[top, k], starts i32[top],
    scores f32[top])`` sorted by descending score."""
    import jax.numpy as jnp
    import numpy as np

    from .peptides import neoantigen_candidates

    windows, starts = neoantigen_candidates(prog, tape, k)
    if windows.shape[0] == 0:
        return windows, starts, jnp.zeros(0, jnp.float32)
    if params is None:
        params = init_params(k)
    scores = score_windows(windows, params)
    order = np.argsort(-np.asarray(scores))[:top]
    return windows[order], starts[order], scores[order]

"""Training loop for the peptide scoring head: close the --neoantigen_params
loop.

``--neoantigen_params`` loads trained weights (scoring.load_params), but the
reference ecosystem gives a user no way to PRODUCE them. This module is that
missing piece: fit the scoring head (scoring.score_windows -- the exact
forward the ranking paths run, so train/serve cannot skew) on labeled
peptide windows and save an ``.npz`` in load_params' schema.

Device-first by construction:

* the forward IS the serving forward: one-hot -> folded bf16 matmul stack
  with fp32 accumulation;
* one jitted adam step over static bucket shapes (pad + mask, no
  data-dependent shapes, no per-epoch retraces);
* epoch shuffling via jax.random under a fixed seed -- bit-reproducible
  runs;
* gradients in fp32 (params are fp32; only the matmul compute is bf16, the
  standard mixed-precision recipe);
* the WHOLE fit is one jitted dispatch (scan over epochs, device-side
  shuffle, scan over batches) and one flat result fetch, so no per-step
  host involvement remains.

No reference analogue (the reference has no scoring subsystem at all); the
architecture is a deliberately small production-shaped scaffold, see
scoring.py.
"""
from __future__ import annotations

import numpy as np

from .scoring import VOCAB, init_params, score_windows


def _bucket(n: int, floor: int = 256) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def fit(windows: np.ndarray, labels: np.ndarray, k: int = None,
        epochs: int = 30, batch_size: int = 4096, learning_rate: float = 1e-3,
        seed: int = 0, params: dict = None, l2: float = 0.0,
        verbose: bool = False, mesh=None) -> dict:
    """Fit the scoring head on ``windows u8[N, k]`` / ``labels f32[N]``.

    Binary labels train with sigmoid cross-entropy; continuous labels (any
    value outside {0, 1}) with mean-squared error -- both on the raw score
    the ranking paths sort by. Returns the trained params pytree (plain
    dict of np arrays, ready for save_params / load_params).

    ``mesh``: a ``dp`` mesh (parallel/mesh.make_mesh) runs the same run
    DATA-PARALLEL: every device holds the (small) dataset and the
    replicated params, each processes ``batch/D`` rows of every global
    batch, and gradients are ``psum``-combined -- the one collective in the
    framework. The global batch composition, shuffle sequence, and update
    math are identical to the single-device run (the loss divides by the
    psum'd global mask count), so scaling devices does not change the
    training trajectory beyond float reassociation.
    """
    import jax
    import jax.numpy as jnp
    import optax

    windows = np.asarray(windows, np.uint8)
    labels = np.asarray(labels, np.float32)
    n, wk = windows.shape
    if n == 0:
        raise ValueError(
            "no training rows: windows is empty (e.g. --holdout 1.0 leaves "
            "nothing to fit on)"
        )
    if k is None:
        k = wk
    if wk != k:
        raise ValueError(f"windows are {wk}-mers but k={k}")
    if labels.shape != (n,):
        raise ValueError("labels must be f32[N] aligned with windows")
    if params is None:
        params = init_params(k, seed=seed)
    params = {key: jnp.asarray(v, jnp.float32) for key, v in params.items()}
    binary = bool(np.isin(labels, (0.0, 1.0)).all())

    n_shards = mesh.devices.size if mesh is not None else 1
    batch_size = min(_bucket(batch_size), _bucket(max(n, 1)))
    batch_size = max(batch_size, n_shards)  # every shard sees >= 1 row
    if batch_size % n_shards:
        # non-power-of-two meshes (e.g. 6 devices): round up to the next
        # multiple so every shard takes an equal slice of every batch --
        # padding + masking absorbs the extra rows exactly like bucketing
        batch_size += n_shards - batch_size % n_shards
    n_batches = (n + batch_size - 1) // batch_size
    padded = n_batches * batch_size
    win_p = np.zeros((padded, k), np.uint8)
    win_p[:n] = windows
    lab_p = np.zeros(padded, np.float32)
    lab_p[:n] = labels
    mask_p = np.zeros(padded, np.float32)
    mask_p[:n] = 1.0

    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)

    def loss_terms(p, w, y, m):
        """(masked loss sum, l2 term) on this shard's rows; the caller
        supplies the GLOBAL denominator so dp shards stay exactly
        equivalent to the single-device batch."""
        s = score_windows(w, p)
        if binary:
            per = optax.sigmoid_binary_cross_entropy(s, y)
        else:
            per = (s - y) ** 2
        return jnp.sum(per * m)

    def l2_term(p):
        return l2 * sum(
            jnp.sum(v * v) for key, v in p.items() if key.startswith("w")
        )

    # The ENTIRE fit is one jitted dispatch: scan over epochs, each epoch a
    # device-side shuffle (jax.random.permutation + gather) and an inner
    # scan over batches. Nothing returns to the host until the final params
    # fetch: the single-dispatch form removes all per-step host
    # involvement; epochs is a static scan length, so one compile serves a
    # given (N, batch, k).
    def fit_body(p, st, key, wd, yd, md, shard_slice, psum):
        def local_loss(p, w, y, m):
            cnt = psum(jnp.sum(m))
            loss = loss_terms(p, w, y, m) / jnp.maximum(cnt, 1.0)
            if l2:
                # added once globally: each shard contributes 1/D of it
                loss = loss + l2_term(p) / n_shards
            return loss

        def epoch(carry, _):
            p, st, key = carry
            key, sub = jax.random.split(key)
            # the permutation is computed from the same key on every shard
            # (replicated), so the GLOBAL batch composition is identical at
            # any device count; each shard gathers only its row range
            order = shard_slice(jax.random.permutation(sub, padded))
            rows = order.shape[0] // n_batches
            wb = jnp.take(wd, order, axis=0).reshape(n_batches, rows, k)
            yb = jnp.take(yd, order).reshape(n_batches, rows)
            mb = jnp.take(md, order).reshape(n_batches, rows)

            def body(carry, xs):
                p, st = carry
                w, y, m = xs
                loss, grads = jax.value_and_grad(local_loss)(p, w, y, m)
                # NO manual grad psum: params enter shard_map REPLICATED, so
                # AD already psums their cotangents across 'dp' (a manual
                # psum here over-counts by the mesh size -- caught by the
                # parity test). The loss VALUE is a fresh per-shard partial
                # and does need the explicit reduction for reporting.
                loss = psum(loss)
                updates, st = opt.update(grads, st, p)
                return (optax.apply_updates(p, updates), st), loss

            (p, st), losses = jax.lax.scan(body, (p, st), (wb, yb, mb))
            return (p, st, key), losses

        (p, st, _), losses = jax.lax.scan(
            epoch, (p, st, key), None, length=epochs
        )
        # ONE flat result buffer: the trained params (and the loss curve)
        # come back in a single transfer
        return jnp.concatenate(
            [p[name].ravel() for name in sorted(p)] + [losses.ravel()]
        )

    if mesh is None:
        @jax.jit
        def fit_fn(p, st, key, wd, yd, md):
            return fit_body(
                p, st, key, wd, yd, md,
                shard_slice=lambda order: order,
                psum=lambda x: x,
            )
    else:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        assert batch_size % n_shards == 0  # rounded up above
        rows = batch_size // n_shards

        def per_shard(p, st, key, wd, yd, md):
            idx = jax.lax.axis_index("dp")

            def shard_slice(order):
                # rows [idx*rows, (idx+1)*rows) of every global batch
                return jax.lax.dynamic_slice_in_dim(
                    order.reshape(n_batches, n_shards * rows),
                    idx * rows, rows, axis=1,
                ).reshape(-1)

            return fit_body(
                p, st, key, wd, yd, md,
                shard_slice=shard_slice,
                psum=lambda x: jax.lax.psum(x, "dp"),
            )

        fit_fn = jax.jit(shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P()),
            out_specs=P(),
        ))

    flat = np.asarray(fit_fn(
        params, opt_state, jax.random.PRNGKey(seed), win_p, lab_p, mask_p
    ))
    out = {}
    off = 0
    for name in sorted(params):
        size = int(np.prod(params[name].shape))
        out[name] = flat[off:off + size].reshape(params[name].shape)
        off += size
    if verbose:
        losses = flat[off:].reshape(epochs, n_batches)
        for e, row in enumerate(losses):
            print(f"epoch {e + 1}/{epochs}: loss {row.mean():.5f}")
    return {name: np.asarray(v, np.float32) for name, v in out.items()}


def save_params(path: str, params: dict) -> None:
    """Save trained weights in the ``--neoantigen_params`` schema
    (scoring.load_params validates shapes on the way back in); any head
    width/depth round-trips."""
    np.savez(
        path,
        **{name: np.asarray(v, np.float32) for name, v in params.items()},
    )


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (the ranking paths sort by score, so ranking quality
    is the metric that matters)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels) > 0.5
    pos, neg = scores[labels], scores[~labels]
    if not len(pos) or not len(neg):
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty(len(order), np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    return float(
        (ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2)
        / (len(pos) * len(neg))
    )

"""Device-side self-validation of the task stream.

The reference reserved a ``DEBUG_GPU`` check of the GPU input arrays for its
(stubbed) accelerator (reference: cli.rs:96, gir.rs:283-299). This build
realizes it as one jitted masked reduction, run on the device right before
the executor consumes the program: it counts, in one pass over the padded
task arrays, every pair of neighbouring tasks that does not tile the result
tape contiguously and every source or destination span out of bounds. That
guards the executor's delta-expansion precondition right next to where it is
consumed. XLA fuses the whole check into one reduction, so no hand-written
kernel is needed.
"""
from __future__ import annotations

import functools

import numpy as np

from .pack import pad_to_bucket


def count_violations(dst, length, srcb, n_tasks, combined_len, res_len):
    """Number of violated task-stream invariants among the first ``n_tasks``
    entries of the (padded) task arrays; pure jnp, jit-compatible."""
    import jax.numpy as jnp

    live = jnp.arange(dst.shape[0], dtype=jnp.int32) < n_tasks
    ends = dst + length
    # contiguity: each task starts where its predecessor ends
    contig_bad = jnp.sum(live[1:] & (dst[1:] != ends[:-1]), dtype=jnp.int32)
    src_bad = jnp.sum(
        live & ((srcb < 0) | (srcb + length > combined_len)), dtype=jnp.int32
    )
    dst_bad = jnp.sum(live & ((dst < 0) | (ends > res_len)), dtype=jnp.int32)
    return contig_bad + src_bad + dst_bad


@functools.lru_cache(maxsize=1)
def _validator():
    import jax

    return jax.jit(count_violations)


def validate_on_device(dst, length, srcb, combined_len: int, res_len: int,
                       device=None) -> int:
    """Device-side task-program validation.

    Returns the number of violated invariants (0 = valid). The task arrays
    are padded to a power-of-two bucket so one compile serves every chunk of
    a run; the live count and the bounds are traced scalars.
    """
    n = len(dst)
    if n == 0:
        return 0
    import jax

    from ..utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    padded = pad_to_bucket(n)
    arrays = []
    for a in (dst, length, srcb):
        p = np.zeros(padded, dtype=np.int32)
        p[:n] = a
        arrays.append(jax.device_put(p, device))
    return int(
        _validator()(
            *arrays, np.int32(n), np.int32(combined_len), np.int32(res_len)
        )
    )


def check_packed(packed, blob_len: int, device=None) -> None:
    """DEBUG_GPU: validate one packed chunk on the device; raise on any
    violation (the reference's check panics)."""
    errors = validate_on_device(
        packed.dst, packed.length, packed.src_biased,
        combined_len=blob_len + len(packed.alt), res_len=packed.total_res,
        device=device,
    )
    if errors:
        raise AssertionError(
            f"device-side task-stream validation failed: {errors} "
            "invariant violations"
        )

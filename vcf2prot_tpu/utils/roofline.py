"""Device-peak accounting: turn a kernel time into a roofline share.

Peaks are keyed by ``jax.devices()[0].device_kind``; a device that is not in
the table is an error, not a default. Source: NVIDIA's H100 data sheet,
dense rates without sparsity, at the card's full power limit (700 W SXM,
350 W PCIe); a card set below its limit cannot hold its top clock under a
matrix-heavy load, so report the limit beside any share.

The reference publishes no utilization numbers at all (SURVEY 6); its
stubbed accelerator (gir.rs:283-299) is the role these denominators grade.
"""
from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    bf16_flops: float  # dense bf16 tensor-core FLOP/s
    hbm_bps: float     # HBM bytes/s


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(989e12, 3.35e12),  # SXM5
    "NVIDIA H100 PCIe": Peaks(756e12, 2.0e12),
}


def peaks(device_kind: str) -> Peaks:
    """Published peaks of ``device_kind``; raises ``KeyError`` for a device
    the table does not hold."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def scoring_flops_per_window(params: dict) -> float:
    """Dense-matmul FLOPs to score ONE window with the configurable head.

    Counts the serving forward as executed (scoring.score_windows): the
    folded one-hot matmul [1, k*V] @ [k*V, H1] plus the hidden stack and
    the [H, 1] output head, 2 FLOPs per MAC. The per-call embedding fold
    is amortized over the whole batch and excluded (it is O(k*V*E*H) once
    per dispatch vs O(windows * k*V*H)).
    """
    from ..downstream.scoring import layer_names

    names = layer_names(params)
    flops = 0.0
    for name in names:
        n_in, n_out = params[name].shape
        flops += 2.0 * n_in * n_out
    # the first layer runs against the k*V one-hot, not k*E activations
    n_in, n_out = params[names[0]].shape
    from ..downstream.scoring import VOCAB

    k = n_in // params["embed"].shape[1]
    flops += 2.0 * (k * VOCAB - n_in) * n_out
    return flops


def dense_pass_flops(n_windows: int, params: dict) -> float:
    """Total matmul FLOPs of the dense scoring pass over ``n_windows`` tape
    positions (the device chain scores EVERY position; padding included --
    the device runs them all)."""
    return n_windows * scoring_flops_per_window(params)


def executor_bytes(out_len: int, index_bytes: int = 4) -> float:
    """HBM traffic of the per-byte delta executor for ``out_len`` output
    bytes: read one index lane + one source byte, write one output byte,
    plus the cumsum's read+write of the index lane. The word-aligned
    executor moves far less per output byte, so this overstates its
    traffic."""
    return float(out_len) * (3 * index_bytes + 2)


def mfu(flops: float, seconds: float, device_kind: str) -> float:
    """Fraction of the device's dense bf16 peak achieved."""
    return flops / seconds / peaks(device_kind).bf16_flops


def hbm_fraction(nbytes: float, seconds: float, device_kind: str) -> float:
    """Fraction of the device's HBM-bandwidth peak achieved."""
    return nbytes / seconds / peaks(device_kind).hbm_bps

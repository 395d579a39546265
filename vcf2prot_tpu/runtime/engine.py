"""Execution-engine selection.

The reference threads an ``Engine{ST,MT,GPU}`` enum through every stage, with
the GPU arm stubbed to a panic (reference:
src/data_structures/InternalRep/engines.rs:15, cli.rs:65-66, gir.rs:236-239).
This build supplies the accelerator the reference only stubs: the device
engine runs the executor (and the neoantigen chain) as XLA programs on JAX's
default backend. On the command line ``gpu`` selects it and requires a GPU.
"""
from __future__ import annotations

import functools
from enum import Enum


class Engine(Enum):
    ST = "st"          # single-threaded host execution (the oracle)
    MT = "mt"          # multi-threaded host execution
    DEVICE = "device"  # device (JAX/XLA) execution
    AUTO = "auto"      # device on a GPU backend, else host mt

    @staticmethod
    def from_str(s: str) -> "Engine":
        s = s.lower()
        if s == "st":
            return Engine.ST
        if s == "mt":
            return Engine.MT
        if s == "gpu":
            return Engine.DEVICE
        if s == "auto":
            return Engine.AUTO
        raise ValueError(
            f"unsupported engine: {s} (expected st, mt, gpu or auto)"
        )


class NoGpuError(RuntimeError):
    """``-g gpu`` was asked for but JAX's default backend is not a GPU."""


def require_gpu():
    """The default JAX device, which must be a GPU; raises
    :class:`NoGpuError` otherwise (JAX quietly falls back to the CPU when
    its CUDA plugin cannot start)."""
    import jax

    try:
        dev = jax.devices()[0]
    except RuntimeError as err:  # JAX_PLATFORMS names a backend that failed
        raise NoGpuError(f"no GPU visible to JAX ({err})") from err
    if dev.platform != "gpu":
        raise NoGpuError("no GPU visible to JAX")
    return dev


@functools.cache
def resolve_auto() -> Engine:
    """Placement for ``auto``, decided once per process: the device engine
    when JAX's default backend is a GPU, the host ``mt`` engine otherwise.

    The same rule holds for every product. A FASTA run moves each output
    byte over PCIe, which a GPU host sustains at GB/s, and a neoantigen run
    returns only its ranked rows."""
    import jax

    return Engine.DEVICE if jax.default_backend() == "gpu" else Engine.MT

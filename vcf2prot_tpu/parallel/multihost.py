"""Multi-host (pod-slice) execution.

The reference's only "multi-node" story is a Python process pool running one
binary per sample batch (reference: automation_scripts/parallization_python.py
:196-207). The device-native design runs ONE logical program across hosts:

* ``jax.distributed.initialize`` brings up the multi-host runtime;
* the global mesh spans every chip in the slice on a single ``dp`` axis;
* each host parses/compiles only its own sample shard (a contiguous balanced
  block -- contiguity lets the native column walk skip unowned FORMAT
  columns, and no cross-host data exchange is needed because samples are
  independent and the proteome blob is replicated);
* each host writes its own shard's FASTAs locally (per-host writers, no DCN
  traffic on the output path).

Collectives never appear on the hot path: the proteome blob is replicated at
startup (one broadcast-equivalent host->device upload per host) and the
sample axis is embarrassingly parallel. This is the deliberate layout choice
-- contrast with row-sharding the proteome, which would put an all-gather on
every transcript span read.

Single-host multi-chip uses the same code path (``parallel.sharded``) without
``jax.distributed``.
"""
from __future__ import annotations

import os


def initialize_distributed(coordinator_address: str = None,
                           num_processes: int = None,
                           process_id: int = None) -> None:
    """Bring up the JAX multi-host runtime (no-op if already initialized).

    Arguments left as None fall to ``jax.distributed.initialize``'s own
    discovery, which needs a cluster environment it recognizes; on a plain
    GPU host pass ``coordinator_address``, ``num_processes`` and
    ``process_id``. Call once per host before building the mesh.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as err:
        if "already initialized" not in str(err):
            raise


def host_sample_shard(n_samples: int, process_index: int = None,
                      process_count: int = None):
    """The sample indices this host owns: a CONTIGUOUS block (sizes balanced
    to within one). Contiguity matters for throughput, not correctness: the
    native column walk tab-skips everything before the shard's first column
    at popcount speed and stops right after its last, so each host scans only
    ~1/N of every record's FORMAT region (round-robin would touch them all).
    """
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    base, extra = divmod(n_samples, pc)
    start = pi * base + min(pi, extra)
    return list(range(start, start + base + (1 if pi < extra else 0)))


def count_samples(vcf_path) -> int:
    from ..frontend.vcf_reader import read_vcf

    return len(read_vcf(vcf_path).probands)


def run_multihost_pipeline(cfg):
    """Run the pipeline with this host's sample shard.

    The input VCF is shared (every host reads it; the scan is cheap relative
    to compilation and execution), each host compiles and executes only its
    contiguous sample block, and outputs land in
    ``outdir/shard_<process_index>/``. Merge is a directory union -- sample
    files are disjoint across hosts.
    """
    import jax

    from ..pipeline import PipelineConfig, run_pipeline

    shard_dir = os.path.join(cfg.outdir, f"shard_{jax.process_index()}")
    os.makedirs(shard_dir, exist_ok=True)
    n = count_samples(cfg.vcf_path)
    shard_cfg = PipelineConfig(
        **{**cfg.__dict__, "outdir": shard_dir,
           "sample_indices": host_sample_shard(n)}
    )
    return run_pipeline(shard_cfg)

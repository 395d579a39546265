"""End-to-end pipeline orchestration.

Mirrors the reference driver composition (reference: src/main.rs:10-62,
src/parts/io.rs, src/parts/exec.rs): parse VCF -> per-sample intermediate
maps -> (optional dumps/stats) -> compile -> execute -> write, with the
execution stage dispatched to the host oracle (st/mt) or the device engine.
"""
from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .compiler.haplotype import RefBlob
from .compiler.proband import compile_proband
from .compiler.qc import QcConfig, default_qc
from .frontend import fasta, vcf_reader
from .frontend.maps import build_int_map_from_early
from .io.writers import (
    PersonalizedProteome,
    write_intmap2json,
    write_num_mutation_per_proband,
    write_number_of_mutations_per_transcript,
    write_type_mutations_per_patient,
)
from .runtime import cpu_engine
from .runtime.engine import Engine
from .stats.summary import compute_stats
from .utils.timers import StageTimer

# Haplotype programs are executed in chunks bounded by result-tape bytes so
# device buffers stay well under HBM while still amortizing dispatch.
# Both defaults were tuned on another accelerator and are not yet measured
# on the H100.
DEFAULT_CHUNK_RES_BYTES = 256 * 1024 * 1024
# The device-resident neoantigen chain defaults smaller: 2^27-lane chunks
# beat 2^28 ones there (smaller working set, more pipeline overlap) while
# 2^26 paid too much per-chunk fixed cost.
DEFAULT_NEO_CHUNK_RES_BYTES = 128 * 1024 * 1024


@dataclass
class PipelineConfig:
    vcf_path: str
    fasta_path: str
    outdir: str
    engine: Engine = Engine.DEVICE
    verbose: bool = False
    compute_stats: bool = False
    write_int_map: bool = False
    write_all: bool = False
    write_compressed: bool = False
    single_thread_writes: bool = False
    num_threads: int = 0
    # None = per-stage default (DEFAULT_CHUNK_RES_BYTES for FASTA output,
    # DEFAULT_NEO_CHUNK_RES_BYTES for the device-resident neoantigen chain);
    # an explicit value applies to both stages
    chunk_res_bytes: int = None
    qc: QcConfig = None
    # use the C++ frontend/compiler when available; stats and int-map dumps
    # need the Python intermediate maps and route through the Python path
    use_native: bool = True
    # resume from a previously dumped int_maps/ directory (skips VCF parsing)
    resume_int_maps: str = ""
    # restrict to a subset of sample indices (multi-host shard assignment)
    sample_indices: list = None
    # write a JAX profiler trace of the execute stage to this directory
    profile_dir: str = ""
    # 0 = off; k>0 writes <proband>.neoantigens.tsv with ranked
    # mutation-overlapping k-mers per sample (downstream/report.py)
    neoantigen_k: int = 0
    # score the cohort's candidate windows in ONE bucketed bf16 device batch
    # (downstream/cohort.py) instead of per-sample host math
    neoantigen_device: bool = False
    # .npz with trained scoring-head weights (downstream/scoring.load_params);
    # empty = the deterministic scaffold initialization
    neoantigen_params: str = ""
    # skip FASTA output entirely: the run's product is the neoantigen TSVs.
    # On the device engine this unlocks the fully device-resident path
    # (downstream/device_resident.py) -- tapes never leave the device, only
    # [samples, top] score rows do
    neoantigen_only: bool = False
    # ranked rows kept per sample in the neoantigen TSVs
    neoantigen_top: int = 200


@dataclass
class PipelineResult:
    proteomes: list = field(default_factory=list)
    n_samples: int = 0
    n_haplotype_seqs: int = 0
    total_output_bytes: int = 0
    durations: dict = field(default_factory=dict)
    # device-resident neoantigen chunks that fell back to the host chain
    # (malformed pack, non-tiling annotations, >2 GiB chunk)
    neo_host_chunks: int = 0


def parse_vcf_to_int_maps(vcf_path, num_threads=0):
    vcf = vcf_reader.read_vcf(vcf_path)
    early = vcf_reader.build_early_maps(vcf, num_threads=num_threads)
    if num_threads and num_threads > 1:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            return list(pool.map(build_int_map_from_early, early))
    return [build_int_map_from_early(e) for e in early]


def _chunk_indices(programs, chunk_res_bytes, pair_aligned=False):
    """Greedy chunking of haplotype programs by result size.

    ``pair_aligned`` keeps (hap1, hap2) pairs in the same chunk so whole
    samples complete chunk-by-chunk (needed for streaming writes).
    """
    step = 2 if pair_aligned else 1
    chunks = []
    cur = []
    cur_bytes = 0
    for i in range(0, len(programs), step):
        group = list(range(i, min(i + step, len(programs))))
        size = sum(programs[g].res_len for g in group)
        if cur and cur_bytes + size > chunk_res_bytes:
            chunks.append(cur)
            cur = []
            cur_bytes = 0
        cur.extend(group)
        cur_bytes += size
    if cur:
        chunks.append(cur)
    return chunks


def _validate_host_programs(programs):
    """Pre-execution contiguity validation of each task stream -- the
    reference's DEBUG_CPU_EXEC check (gir.rs:203-229)."""
    import numpy as np

    for idx, p in enumerate(programs):
        if p.n_tasks == 0:
            continue
        ends = p.dst + p.length
        if (
            int(p.dst[0]) != 0
            or not np.all(p.dst[1:] == ends[:-1])
            or int(ends[-1]) != p.res_len
        ):
            raise AssertionError(
                f"DEBUG_CPU_EXEC: task stream of haplotype {idx} is not "
                "contiguous with its result tape"
            )


def execute_programs(programs, blob, engine: Engine,
                     chunk_res_bytes=DEFAULT_CHUNK_RES_BYTES,
                     validate_device=False, validate_host=False):
    """Execute haplotype programs with the selected engine; returns one uint8
    array per program."""
    if validate_host:
        _validate_host_programs(programs)
    if engine is Engine.AUTO:
        from .runtime.engine import resolve_auto

        engine = resolve_auto()
    if engine is Engine.DEVICE:
        import jax

        outputs = [None] * len(programs)
        if jax.local_device_count() > 1:
            # multi-chip within this host: dp-sharded programs over the local
            # devices, chunked so per-device buffers stay bounded
            # (cross-host parallelism is sample sharding, parallel/multihost.py)
            from .parallel.mesh import make_mesh
            from .parallel.sharded import ShardedEngine

            mesh = make_mesh()
            dev = ShardedEngine(blob, mesh)
            budget = chunk_res_bytes * mesh.devices.size
            for chunk in _chunk_indices(programs, budget):
                if validate_device:
                    _check_chunk([programs[i] for i in chunk], blob)
                outs = dev.execute([programs[i] for i in chunk])
                for i, o in zip(chunk, outs):
                    outputs[i] = o
            return outputs
        for chunk, outs in _device_chunk_results(
            programs, blob, chunk_res_bytes, validate_device
        ):
            for i, o in zip(chunk, outs):
                outputs[i] = o
        return outputs
    if engine is Engine.MT:
        with ThreadPoolExecutor() as pool:
            return list(
                pool.map(
                    lambda p: cpu_engine.execute_tasks_fast(p, blob), programs
                )
            )
    return [cpu_engine.execute_tasks(p, blob) for p in programs]


def _check_chunk(programs, blob):
    """DEBUG_GPU for the dp-sharded executor: validate the chunk's whole
    task stream on the first local device before it is sharded."""
    from .runtime.kernels import check_packed
    from .runtime.pack import pack_cohort

    check_packed(pack_cohort(programs, blob), len(blob.data))


def _device_chunk_results(programs, blob, chunk_res_bytes, validate_device,
                          pair_aligned=False):
    """Depth-2 chunk pipeline over the single-device engine: one chunk
    computes on device while the previous chunk's result streams back; yields
    ``(chunk_indices, outputs)`` in order."""
    from collections import deque

    from .runtime.device_engine import DeviceEngine

    dev = DeviceEngine(blob, validate_on_device=validate_device)
    pending = deque()
    for chunk in _chunk_indices(programs, chunk_res_bytes, pair_aligned):
        pending.append((chunk, dev.dispatch([programs[i] for i in chunk])))
        if len(pending) > 1:
            chunk_done, handle = pending.popleft()
            yield chunk_done, dev.collect(handle)
    while pending:
        chunk_done, handle = pending.popleft()
        yield chunk_done, dev.collect(handle)


def _write_stats_tables(outdir, per_proband, per_type, per_transcript):
    """The three -s TSVs (shared by the native and Python stats paths)."""
    write_num_mutation_per_proband(outdir, per_proband)
    write_type_mutations_per_patient(outdir, per_type)
    write_number_of_mutations_per_transcript(outdir, per_transcript)


def run_pipeline(cfg: PipelineConfig) -> PipelineResult:
    timer = StageTimer(cfg.verbose)
    qc = cfg.qc if cfg.qc is not None else default_qc()
    result = PipelineResult()

    with timer.stage("Loading the Reference file"):
        ref_seqs = fasta.read_fasta(cfg.fasta_path)
        blob = RefBlob.from_ref_seqs(ref_seqs)

    # int-map dumps need the Python intermediate maps; stats come from the
    # native compiler's stats blocks; the DEBUG_TXP trace lives in the
    # Python compiler
    native_result = None
    need_int_maps = cfg.write_int_map
    if (cfg.use_native and not need_int_maps and not cfg.resume_int_maps
            and not qc.debug_txp):
        from .native_bridge import compile_cohort_native

        with timer.stage("Parsing and compiling (native)"):
            # sample shards are pushed INTO the decode+compile (only owned
            # FORMAT columns are decoded, only owned haplotypes compiled) so
            # multi-host runs split the dominant stage instead of each host
            # redoing the full cohort
            native_result = compile_cohort_native(
                cfg.vcf_path, ref_seqs, blob, qc, cfg.num_threads,
                collect_stats=cfg.compute_stats, alt_pool="auto",
                sample_subset=cfg.sample_indices,
            )

    if native_result is not None:
        stats_blocks = None
        if cfg.compute_stats:
            probands, flat, warnings, stats_blocks = native_result
        else:
            probands, flat, warnings = native_result
        # per-transcript skip warnings repeat across carriers; cap the spam
        seen = set()
        shown = 0
        for w in warnings:
            if w in seen:
                continue
            seen.add(w)
            if shown < 20:
                print(w, file=sys.stderr)
                shown += 1
        if len(seen) > shown:
            print(
                f"... and {len(seen) - shown} more distinct transcript "
                "warnings", file=sys.stderr,
            )
        # sample_indices were applied inside the native compile: `probands`,
        # `flat` and `stats_blocks` already cover only the owned shard
        proband_names = probands
        if stats_blocks is not None:
            from .stats.native_stats import stats_from_native

            with timer.stage("Computing and writing the stats"):
                _write_stats_tables(
                    cfg.outdir, *stats_from_native(proband_names, stats_blocks)
                )
    else:
        if cfg.resume_int_maps:
            from .io.checkpoint import read_intmap_json

            with timer.stage("Resuming from int-map checkpoint"):
                int_maps = read_intmap_json(cfg.resume_int_maps)
        else:
            with timer.stage("Reading and loading the VCF file"):
                int_maps = parse_vcf_to_int_maps(cfg.vcf_path, cfg.num_threads)
        if cfg.sample_indices is not None:
            keep = set(cfg.sample_indices)
            int_maps = [m for i, m in enumerate(int_maps) if i in keep]

        if cfg.write_int_map:
            with timer.stage("Writing the intermediate representation map"):
                write_intmap2json(os.path.join(cfg.outdir, "int_maps"), int_maps)

        if cfg.compute_stats:
            with timer.stage("Computing and writing the stats"):
                _write_stats_tables(cfg.outdir, *compute_stats(int_maps))

        with timer.stage("Generating personalized genomes (compile)"):
            from .compiler.haplotype import (
                AltPool, attach_pool, cohort_should_pool,
            )

            compile_cache: dict = {}
            alt_pool = AltPool() if cohort_should_pool(int_maps) else None
            proband_programs = [
                compile_proband(m, ref_seqs, blob, qc, compile_cache, alt_pool)
                for m in int_maps
            ]
            proband_names = [pp.proband for pp in proband_programs]
            flat = []
            for pp in proband_programs:
                flat.append(pp.hap1)
                flat.append(pp.hap2)
            if alt_pool is not None:
                attach_pool(flat, alt_pool)

    engine = cfg.engine
    if engine is Engine.AUTO:
        from .runtime.engine import resolve_auto

        engine = resolve_auto()
    if engine is Engine.DEVICE and cfg.verbose:
        import jax

        dev = jax.devices()[0]
        print(f"Device engine on {dev.platform} ({dev.device_kind}) "
              f"x{jax.local_device_count()}")
    if qc.debug_cpu_exec:
        _validate_host_programs(flat)

    neo_acc = None
    neo_params = None
    if cfg.neoantigen_k and cfg.neoantigen_params:
        from .downstream.scoring import load_params

        neo_params = load_params(cfg.neoantigen_params, cfg.neoantigen_k)

    if cfg.neoantigen_k and cfg.neoantigen_only and engine is Engine.DEVICE:
        # fully device-resident: execute + mask + score + top-k in HBM; the
        # only device->host traffic is [samples, top] rows. Multi-device
        # hosts run the dp-sharded chain (samples partitioned over the mesh,
        # blob replicated, no collectives)
        import jax

        from .downstream.device_resident import (
            write_device_neoantigen_reports,
        )

        mesh = None
        if jax.local_device_count() > 1:
            from .parallel.mesh import make_mesh

            mesh = make_mesh()
        neo_chunk_bytes = (
            cfg.chunk_res_bytes
            if cfg.chunk_res_bytes is not None
            else DEFAULT_NEO_CHUNK_RES_BYTES
        )
        with timer.stage("Neoantigen scoring (device-resident)"):
            _paths, result.neo_host_chunks = write_device_neoantigen_reports(
                cfg.outdir, proband_names, flat, blob, cfg.neoantigen_k,
                params=neo_params, top=cfg.neoantigen_top,
                chunk_res_bytes=neo_chunk_bytes, mesh=mesh,
            )
        for p in flat:
            result.n_haplotype_seqs += len(p.annotations)
            result.total_output_bytes += p.res_len
        result.n_samples = len(proband_names)
        result.durations = dict(timer.durations)
        return result

    if cfg.neoantigen_k and cfg.neoantigen_device:
        from .downstream.cohort import CohortCandidates

        neo_acc = CohortCandidates(cfg.neoantigen_k)

    def finish_sample(i, h1, h2):
        hap1, hap2 = flat[2 * i], flat[2 * i + 1]
        if not cfg.neoantigen_only:
            proteome = PersonalizedProteome(
                proband_names[i], h1, hap1.annotations, h2, hap2.annotations
            )
            proteome.write(
                cfg.outdir,
                write_all=cfg.write_all,
                write_compressed=cfg.write_compressed,
                ref_seqs=ref_seqs,
            )
        if neo_acc is not None:
            neo_acc.add(i, 1, hap1, h1)
            neo_acc.add(i, 2, hap2, h2)
        elif cfg.neoantigen_k:
            from .downstream.report import write_neoantigen_report

            write_neoantigen_report(
                cfg.outdir, proband_names[i], (hap1, hap2), (h1, h2),
                cfg.neoantigen_k, params=neo_params, top=cfg.neoantigen_top,
            )
        return (
            len(hap1.annotations) + len(hap2.annotations),
            h1.size + h2.size,
        )

    def account(stats):
        for n_seqs, n_bytes in stats:
            result.n_haplotype_seqs += n_seqs
            result.total_output_bytes += n_bytes

    fasta_chunk_bytes = (
        cfg.chunk_res_bytes
        if cfg.chunk_res_bytes is not None
        else DEFAULT_CHUNK_RES_BYTES
    )
    with timer.stage("Generating and writing personalized genomes"):
        from .utils.timers import jax_trace

        with jax_trace(cfg.profile_dir or None):
            if engine is Engine.DEVICE:
                # device path: chunked, sample-pair-aligned execution with
                # per-chunk streaming writes; one chunk computes on device
                # while the previous chunk's samples are written, so host
                # memory stays bounded by the chunk size
                import jax

                if jax.local_device_count() > 1:
                    from .parallel.mesh import make_mesh
                    from .parallel.sharded import ShardedEngine

                    mesh = make_mesh()
                    dev = ShardedEngine(blob, mesh)
                    budget = fasta_chunk_bytes * mesh.devices.size
                    for chunk in _chunk_indices(
                        flat, budget, pair_aligned=True
                    ):
                        if qc.debug_device_exec:
                            _check_chunk([flat[i] for i in chunk], blob)
                        outs = dev.execute([flat[i] for i in chunk])
                        account(
                            finish_sample(chunk[j] // 2, outs[j], outs[j + 1])
                            for j in range(0, len(chunk), 2)
                        )
                else:
                    for chunk, outs in _device_chunk_results(
                        flat, blob, fasta_chunk_bytes,
                        qc.debug_device_exec, pair_aligned=True,
                    ):
                        account(
                            finish_sample(chunk[j] // 2, outs[j], outs[j + 1])
                            for j in range(0, len(chunk), 2)
                        )
            else:
                # host path: fused execute+write per sample, streamed through
                # a thread pool -- tapes never accumulate
                def one_sample(i):
                    run = (
                        cpu_engine.execute_tasks_fast
                        if engine is Engine.MT
                        else cpu_engine.execute_tasks
                    )
                    h1 = run(flat[2 * i], blob)
                    h2 = run(flat[2 * i + 1], blob)
                    return finish_sample(i, h1, h2)

                indices = range(len(proband_names))
                if engine is Engine.MT and not cfg.single_thread_writes:
                    with ThreadPoolExecutor(
                        max_workers=cfg.num_threads or os.cpu_count()
                    ) as pool:
                        account(pool.map(one_sample, indices))
                else:
                    account(map(one_sample, indices))

    if neo_acc is not None:
        with timer.stage("Scoring neoantigen candidates (device batch)"):
            from .downstream.cohort import write_reports_from_candidates

            write_reports_from_candidates(
                cfg.outdir, proband_names, flat, neo_acc.arrays(),
                cfg.neoantigen_k, params=neo_params, top=cfg.neoantigen_top,
            )

    result.n_samples = len(proband_names)
    result.durations = dict(timer.durations)
    return result

"""vcf2prot_tpu: a JAX/XLA personalized-proteome engine.

Takes a reference proteome FASTA and a phased, bcftools/csq-annotated VCF and
emits one FASTA per sample containing that sample's personalized proteome
(both haplotypes). Capability-parity rebuild of ikmb/vcf2prot with a
JAX/XLA execution core, a C++ native host tier and a Python oracle tier.

Library use (the reference exposes five library modules, lib.rs:8-12; the
equivalents here):

    from vcf2prot_tpu import PipelineConfig, run_pipeline, Engine
    result = run_pipeline(PipelineConfig(
        vcf_path="cohort.vcf", fasta_path="proteome.fasta",
        outdir="out", engine=Engine.AUTO,
    ))

Lower layers are importable individually: ``frontend`` (readers/lexer/
bitmask/mutation model), ``compiler`` (instruction ISA, transcript/haplotype
compilers, QC), ``runtime`` (engines, packing, kernels), ``parallel``
(mesh/sharded/multihost), ``io`` (writers, checkpoint), ``stats``.
"""

__version__ = "0.1.0"

from .pipeline import PipelineConfig, PipelineResult, run_pipeline  # noqa: F401
from .runtime.engine import Engine  # noqa: F401

__all__ = [
    "PipelineConfig",
    "PipelineResult",
    "run_pipeline",
    "Engine",
    "__version__",
]

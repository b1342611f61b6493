"""longtr_tpu — an accelerated tandem-repeat genotyping framework.

A from-scratch re-design of the capabilities of gymrek-lab/LongTR
(long-read STR/VNTR genotyper) for an NVIDIA GPU driven from JAX:

* the read-vs-haplotype pair-HMM DP runs as a batched CUDA kernel (see
  ``longtr_tpu.ops.pairhmm``), replacing the per-cell C++ loops of
  the reference (reference: src/SeqAlignment/HapAligner.cpp),
* genotype-posterior and EM stutter-model math is vectorized over padded
  locus batches (reference: src/genotyper.cpp, src/em_stutter_genotyper.cpp),
* host-side I/O (BAM/FASTA/VCF) is implemented natively — no htslib
  dependency (reference: src/bam_io.cpp wraps htslib),
* loci shard across a ``jax.sharding.Mesh`` over the local GPUs
  (the reference is single-threaded; README.md:78-82).
"""

from longtr_tpu.version import __version__

__all__ = ["__version__"]

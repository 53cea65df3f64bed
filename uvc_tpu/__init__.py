"""uvc_tpu: a JAX somatic variant-calling engine for one NVIDIA GPU.

A from-scratch JAX/XLA rebuild of the capabilities of genetronhealth/uvc
(reference surveyed in SURVEY.md): tumor-only and tumor-normal small-variant
calling from BAM with UMI/duplex molecular-barcode consensus, the
power-law/binomial/Bayes-factor "universality" quality model, and bgzipped VCF
output.

Architecture (not a port):
  - io/        BAM/FASTA/VCF codecs (native C++ BGZF+BAM decoder behind ctypes,
               pure-python fallback) producing columnar numpy read blocks
  - schedule/  memory-bounded region planner (tier-1/2/3 batching)
  - family/    UMI dedup + family grouping (host hash keys, device reductions)
  - pileup/    CIGAR expansion -> flat event tensors -> [P, 14, C] count tensors
  - stats/     segment-bias statistics (SegPrep/SegThres/SegInfo/FamInfo)
  - model/     dp4_to_pcFA / binomial-LR / power-law quality model (pure jnp)
  - vcfout/    declarative FORMAT schema, header, record emission
  - parallel/  jax.sharding mesh utilities, multi-host merge
  - cli/       uvc1-compatible CLI and uvcTN driver
"""

__version__ = "0.1.0"

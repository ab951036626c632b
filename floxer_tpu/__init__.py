"""floxer-tpu: an exact long-read DNA aligner on the GPU.

A JAX/XLA/CUDA implementation with the capabilities of the reference C++
aligner floxer (feldroop/floxer): exact alignment of noisy long reads via
approximate FM-index search with optimal search schemes, PEX
(pigeonhole-exact) hierarchical verification with banded edit-distance
kernels, heuristic anchor selection for repetitive regions, and SAM/BAM
output.

Architecture (a batched device pipeline, not a port):
  - host layer: FASTA/FASTQ streaming, rank encoding, PEX tree construction,
    search-scheme generation, batching/padding, SAM/BAM emission, statistics
  - device layer: batched FM-index rank/locate gathers, masked-frontier
    search-scheme traversal, top-k anchor selection
  - kernels: banded semi-global edit distance (Myers bit-parallel) as a
    CUDA kernel for Hopper through jax.ffi, full-state Myers as plain XLA
  - scale-out: jax.sharding.Mesh data-parallel read batches, replicated or
    sharded index, collective stats merge and alignment gather
"""

__version__ = "0.1.0"

PROGRAM_NAME = "floxer-tpu"

"""Program metadata (parity: include/about_floxer.hpp)."""

PROGRAM_NAME = "floxer-tpu"
VERSION = "0.1.0"
VERSION_DATE = "2026-08-17"
SHORT_DESCRIPTION = (
    "FM-index longread aligner with explicit number of errors, on the GPU"
)
LONG_DESCRIPTION = (
    "floxer-tpu is an exact longread aligner for GPUs using FM-index search "
    "with optimal search schemes, the PEX hierarchical verification scheme "
    "and CUDA/JAX banded edit-distance kernels. It is a from-scratch "
    "implementation of the capabilities of floxer "
    "(github.com/feldroop/floxer) as a batched device pipeline."
)
URL = "https://github.com/feldroop/floxer"

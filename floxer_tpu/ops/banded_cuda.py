"""The CUDA banded Myers kernel (native/myers_banded.cu) as a JAX operation.

At first use on a GPU the source is compiled with nvcc for Hopper
(sm_90a) into <checkout>/build/, loaded with ctypes and registered as an
XLA FFI target. `banded_cuda_call` has the signature and the results of
ops/banded._banded_xla, so a fused wave (ops/fused_verify.py) stays one
dispatch. A GPU run that cannot build or load the library raises: there
is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import jax
import jax.numpy as jnp

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "native" / "myers_banded.cu"
BUILD_DIR = _PACKAGE.parent / "build"
LIBRARY = BUILD_DIR / "libfloxer_myers_banded.so"
TARGET = "floxer_myers_banded"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

# the kernel keeps WPL = band_words / 32 words per lane in registers and is
# instantiated for WPL = 4, 8, ..., 32 (native/myers_banded.cu); every band
# width on the device path is a multiple of BAND_WORDS_QUANTUM words
BAND_WORDS_QUANTUM = 128
MAX_BAND_WORDS = 1024

_lock = threading.Lock()
_library = None  # the loaded ctypes library, kept alive once registered


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_FALLBACK):
        return NVCC_FALLBACK
    raise RuntimeError(
        "the CUDA banded kernel needs nvcc, found neither on PATH nor at "
        f"{NVCC_FALLBACK}"
    )


def build_library() -> Path:
    """Compile the kernel library unless an up-to-date one exists."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a per-process path and rename: concurrent processes must
    # never load a half-written library
    tmp_path = LIBRARY.with_suffix(f".tmp{os.getpid()}.so")
    command = [
        _nvcc(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(),
        "-o", str(tmp_path), str(SOURCE),
    ]
    result = subprocess.run(command, capture_output=True, text=True)
    if result.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {SOURCE.name}:\n{result.stderr[-4000:]}"
        )
    os.replace(tmp_path, LIBRARY)
    return LIBRARY


def ensure_registered() -> None:
    """Build, load and register the FFI target once per process."""
    global _library
    with _lock:
        if _library is not None:
            return
        library = ctypes.CDLL(str(build_library()))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(library.FloxerMyersBanded),
            platform="CUDA",
        )
        _library = library


def pack_scalars(scalars) -> jax.Array:
    """The six per-task scalars ([T, 1] or [T] each) as one int32 [T, 6]."""
    num_tasks = scalars[0].shape[0]
    return jnp.concatenate(
        [jnp.reshape(s, (num_tasks, 1)).astype(jnp.int32) for s in scalars],
        axis=1,
    )


def banded_cuda_call(vp0, planes0, texts, stream, scalars):
    """(dist, end), int32 [T, 1] each, from the CUDA kernel."""
    num_tasks, band_words = vp0.shape
    if band_words % BAND_WORDS_QUANTUM or band_words > MAX_BAND_WORDS:
        raise ValueError(
            f"band_words={band_words}: the CUDA kernel takes multiples of "
            f"{BAND_WORDS_QUANTUM} up to {MAX_BAND_WORDS}"
        )
    ensure_registered()
    out = jax.ShapeDtypeStruct((num_tasks, 1), jnp.int32)
    dist, end = jax.ffi.ffi_call(TARGET, (out, out))(
        vp0.astype(jnp.uint32),
        planes0.astype(jnp.uint32),
        texts.astype(jnp.uint32),
        stream.astype(jnp.uint32),
        pack_scalars(scalars),
    )
    return dist, end

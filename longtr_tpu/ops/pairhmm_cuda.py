"""The CUDA pair-HMM kernel (``ops/cuda/pairhmm.cu``) as a JAX operation.

The library is built from the committed source with ``nvcc`` at first use
(into ``ops/cuda/libpairhmm_cuda.so``, git-ignored) and registered as an
XLA FFI target for the CUDA platform.  A failed build is an error: there
is no silent fall back to another path.

Its arithmetic is that of :func:`longtr_tpu.ops.pairhmm.pairhmm_scan` and
the native scorer, bit for bit; the CPU tests check those two, and the
tests marked ``gpu`` check this kernel against them on the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_SRC = os.path.join(_DIR, "pairhmm.cu")
_LIB = os.path.join(_DIR, "libpairhmm_cuda.so")
NVCC = "/usr/local/cuda/bin/nvcc"
TARGET = "longtr_pairhmm"

# Block shapes (threads, read columns per thread) compiled into the
# library.  A pair takes the smallest shape whose strips cover its padded
# read width; wider reads walk their rows in segments of the last shape.
SHAPES = ((32, 8), (64, 8), (128, 8), (256, 8), (256, 16), (512, 16))


def launch_shape(m_width: int) -> tuple[int, int, int]:
    """(threads, columns per thread, segments per row) for a read width."""
    for threads, cols in SHAPES:
        if threads * cols >= m_width:
            return threads, cols, 1
    threads, cols = SHAPES[-1]
    return threads, cols, -(-m_width // (threads * cols))


def scratch_len(batch: int, m_width: int) -> int:
    """f32 elements of the kernel's scratch: the M/I/D rows of every pair
    when rows walk in segments, else one (unused) element."""
    threads, cols, nseg = launch_shape(m_width)
    return batch * 3 * nseg * threads * cols if nseg > 1 else 1


def build_command(out_path: str = _LIB) -> list[str]:
    return [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", out_path, _SRC]


def build() -> str:
    """Compile the library if it is missing or older than its source."""
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    try:
        res = subprocess.run(build_command(tmp), capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {_SRC}:\n{res.stderr}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB


_registered = False


def register():
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.LongtrPairHmm),
                                platform="CUDA")
    _registered = True


def pairhmm_cuda(hap, hap_len, read, read_len, full_hap_len, trans):
    """Traceable kernel call on device arrays: hap (B, N) uint8, read
    (B, M) uint8, lengths (B,) int32, trans (7,) f32 -> (B,) f32."""
    register()
    B, M = read.shape
    threads, cols, nseg = launch_shape(M)
    out, _ = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((B,), jnp.float32),
         jax.ShapeDtypeStruct((scratch_len(B, M),), jnp.float32)),
    )(hap, hap_len, read, read_len, full_hap_len, trans,
      threads=np.int32(threads), cols=np.int32(cols), nseg=np.int32(nseg))
    return out


pairhmm_cuda_jit = jax.jit(pairhmm_cuda)

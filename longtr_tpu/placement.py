"""Where work runs: the one placement rule, and where compiled code is kept.

"On an accelerator" means JAX's default backend is the GPU.  There the
pair-HMM runs on the card; with more than one local card it runs sharded
over a 1-D mesh, and so do the batched posteriors and the stutter EM.
The host scorer (native C++) serves the CPU backend and
reference-fidelity mode, whose f64 scores no device path computes.

``LONGTR_FORCE_MESH=1`` takes the mesh route on CPU devices too, so the
multi-card path can be rehearsed on a virtual CPU mesh
(``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import os

import jax

HOST, DEVICE, MESH = "host", "device", "mesh"


def on_accelerator() -> bool:
    return jax.default_backend() == "gpu"


def use_mesh() -> bool:
    """Whether device work shards over all local devices."""
    return jax.local_device_count() > 1 and (
        on_accelerator() or os.environ.get("LONGTR_FORCE_MESH") == "1")


def pairhmm_route() -> str:
    """HOST, DEVICE or MESH for the next pair-HMM batch."""
    from longtr_tpu.utils import mathops
    if mathops.ref_fidelity():
        return HOST
    if use_mesh():
        return MESH
    return DEVICE if on_accelerator() else HOST


def compile_cache_dir() -> str | None:
    """The persistent compile cache directory the program sets, or None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses it as is)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


_cache_enabled = False


def enable_compile_cache():
    """Keep compiled programs across runs (locus shapes repeat)."""
    global _cache_enabled
    if _cache_enabled:
        return
    cache_dir = compile_cache_dir()
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _cache_enabled = True


def visible_cards(environ=os.environ) -> list[str]:
    """The GPUs a child process may be given, found without starting JAX
    (a JAX process reserves most of a card's memory once it starts)."""
    if "CUDA_VISIBLE_DEVICES" in environ:
        return [c for c in environ["CUDA_VISIBLE_DEVICES"].split(",") if c]
    import shutil
    import subprocess
    if shutil.which("nvidia-smi") is None:
        return []
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.split()


def worker_envs(n: int, environ=os.environ) -> list[dict]:
    """Environments for ``n`` worker processes: one card each on a GPU
    host, unchanged on the CPU backend.  More workers than cards is an
    error, never a silent fall back to the CPU."""
    platforms = environ.get("JAX_PLATFORMS", "")
    cards = ([] if platforms and not {"cuda", "gpu"} & set(
        platforms.lower().split(",")) else visible_cards(environ))
    if not cards:
        return [dict(environ) for _ in range(n)]
    if n > len(cards):
        raise ValueError(f"--workers {n} needs {n} GPUs, but {len(cards)} "
                         f"are visible ({','.join(cards)}); a worker "
                         "process takes a card of its own")
    return [dict(environ, CUDA_VISIBLE_DEVICES=cards[i]) for i in range(n)]

"""The device scoring path: every pair-HMM implementation on the same
batches, the placement rule, placement counts, the compile cache path and
the per-card worker environments.

The CPU cases compare the scan (the GPU path's plain reference), the native
f32 scorer and the f64 scorers.  Cases marked ``gpu`` run the same checks on
the card (``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/test_device_path.py``)."""

import json
import os
import sys

import jax
import numpy as np
import pytest

from longtr_tpu import native, placement
from longtr_tpu.ops import pairhmm
from longtr_tpu.ops.pairhmm import (BAND_FAIL_SCORE, IMPOSSIBLE,
                                    AlignmentParams, encode_seq)
from longtr_tpu.pipeline import seq_genotyper

sys.path.insert(0, os.path.dirname(__file__))

BASES = np.array(list("ACGT"))
CUSTOM = AlignmentParams.from_list([-2.0, -0.3, -1.5, -0.25, -0.0001,
                                    -8.0, -9.0])


def _stack(haps, reads):
    N = max(len(h) for h in haps)
    M = max(len(r) for r in reads)
    H = np.stack([encode_seq(h, N) for h in haps])
    R = np.stack([encode_seq(r, M) for r in reads])
    hl = np.array([len(h) for h in haps], np.int32)
    rl = np.array([len(r) for r in reads], np.int32)
    return H, hl, R, rl, hl + 60


def _noisy(rng, B, nmin, nmax):
    haps, reads = [], []
    for _ in range(B):
        hap = "".join(rng.choice(BASES, int(rng.integers(nmin, nmax))))
        read = []
        for ch in hap:
            r = rng.random()
            if r < 0.005:
                continue
            read.append(ch if r > 0.02 else str(rng.choice(BASES)))
        haps.append(hap)
        reads.append("".join(read) or "A")
    return _stack(haps, reads)


def _skewed(rng):
    """|n - m| of 250-550 bp: the band term keeps the shifted diagonal."""
    haps, reads = [], []
    for k in range(8):
        hap = "".join(rng.choice(BASES, 1024 - int(rng.integers(0, 40))))
        skew = int(rng.integers(250, 550)) * (1 if k % 2 else -1)
        cut = len(hap) // 2
        if skew > 0:
            read = hap[:cut] + hap[cut + skew:]
        else:
            read = hap[:cut] + "".join(rng.choice(BASES, -skew)) + hap[cut:]
        rd = list(read)
        for p in rng.integers(0, len(rd), size=len(rd) // 50):
            rd[p] = str(rng.choice(BASES))
        haps.append(hap)
        reads.append("".join(rd))
    return _stack(haps, reads)


def _batch(case):
    rng = np.random.default_rng(77)
    params = AlignmentParams()
    if case == "gates_and_bandfail":
        H, hl, R, rl, fl = _noisy(rng, 4, 15, 30)
        fl[0] = 60                                   # short hap -> -1e9
        R[1] = encode_seq("G" * int(rl[1]), R.shape[1])   # band fail
    elif case == "custom_params":
        H, hl, R, rl, fl = _noisy(rng, 6, 10, 150)
        params = CUSTOM
    elif case == "long_544x512":
        H, hl, R, rl, fl = _noisy(rng, 8, 272, 544)
        R, rl = R[:, :512], np.minimum(rl, 512)
    elif case == "length_skew":
        H, hl, R, rl, fl = _skewed(rng)
    elif case == "edges":
        H, hl, R, rl, fl = _noisy(rng, 8, 30, 130)
        rl[0] = 64                     # read ends on a 64-bp bucket edge
        hl[1] = 1                      # single-row haplotype
        rl[2] = 1                      # single-base read
        hl[3], rl[3] = 1, 1            # n == m == 1
        H = np.pad(H, ((0, 0), (0, 700)))
        hl[4] = 700 + int(rl[4])       # |n - m| > 600 shortcut
    else:                              # "multi_tile": many small pairs
        H, hl, R, rl, fl = _noisy(rng, 300, 5, 90)
    for i in range(len(hl)):           # codes past a length are padding
        H[i, hl[i]:] = 0
        R[i, rl[i]:] = 0
    return (H, hl, R, rl, fl), params


CASES = ["gates_and_bandfail", "custom_params", "long_544x512",
         "length_skew", "edges", "multi_tile"]


def _check_against_references(got, batch, params):
    """``got`` must equal the native f32 scorer bit for bit and sit within
    f32 rounding of the f64 scorers (the f64 DP runs the sequential D
    recurrence, the f32 paths its exact cummax closed form)."""
    want = native.pairhmm_batch_native(*batch, params.as_array())
    assert want is not None, "native library unavailable"
    assert np.array_equal(got, want)
    f64 = native.pairhmm_batch_native_f64(*batch, params.as_array())
    sentinel = np.isin(f64, (BAND_FAIL_SCORE, IMPOSSIBLE))
    assert np.array_equal(got[sentinel], f64[sentinel].astype(np.float32))
    np.testing.assert_allclose(got[~sentinel], f64[~sentinel],
                               rtol=5e-5, atol=2e-5)
    return f64


@pytest.mark.parametrize("case", CASES)
def test_scan_native_and_f64_agree(case):
    batch, params = _batch(case)
    got = np.asarray(pairhmm.pairhmm_batch(*batch, params))
    f64 = _check_against_references(got, batch, params)
    if case in ("gates_and_bandfail", "edges"):
        H, hl, R, rl, fl = batch
        oracle = [pairhmm.pairhmm_score_oracle(
            bytes(H[i, :hl[i]]).decode(), bytes(R[i, :rl[i]]).decode(),
            params, full_hap_len=int(fl[i])) for i in range(len(hl))]
        assert np.array_equal(f64, np.array(oracle))
    if case == "length_skew":
        assert (got > BAND_FAIL_SCORE).any()


def _fake_backend(monkeypatch, backend, n_dev):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jax, "local_device_count", lambda: n_dev)


@pytest.mark.parametrize("backend,n_dev,fidelity,force_mesh,want", [
    ("gpu", 1, False, False, placement.DEVICE),
    ("cpu", 8, False, False, placement.HOST),
    ("gpu", 1, True, False, placement.HOST),
    ("gpu", 4, False, False, placement.MESH),
    ("cpu", 8, False, True, placement.MESH),
])
def test_pairhmm_route(monkeypatch, backend, n_dev, fidelity, force_mesh,
                       want):
    from longtr_tpu.utils import mathops
    _fake_backend(monkeypatch, backend, n_dev)
    if force_mesh:
        monkeypatch.setenv("LONGTR_FORCE_MESH", "1")
    else:
        monkeypatch.delenv("LONGTR_FORCE_MESH", raising=False)
    mathops.set_ref_fidelity(fidelity)
    try:
        assert placement.pairhmm_route() == want
        assert placement.use_mesh() == (want == placement.MESH)
    finally:
        mathops.set_ref_fidelity(False)


@pytest.mark.parametrize("route", [placement.HOST, placement.DEVICE,
                                   placement.MESH])
def test_chunk_counts_follow_route(monkeypatch, route):
    """Each chunk is counted on the side that scored it, and every route
    returns the same scores."""
    monkeypatch.setattr(placement, "pairhmm_route", lambda: route)
    rng = np.random.default_rng(3)
    pairs = []
    for n in (40, 40, 90, 300, 300, 300):   # three length classes
        hap = "".join(rng.choice(BASES, n))
        pairs.append((hap, hap[: n - 3], n + 60))
    handle = seq_genotyper.score_pairs_async(pairs)
    scores = handle.result()
    n_chunks = handle.n_device + handle.n_host
    assert n_chunks == 3
    if route == placement.HOST:
        assert (handle.n_device, handle.n_host) == (0, 3)
    else:
        assert (handle.n_device, handle.n_host) == (3, 0)
    H, hl, R, rl, fl = _stack([p[0] for p in pairs], [p[1] for p in pairs])
    want = native.pairhmm_batch_native(H, hl, R, rl, fl,
                                       AlignmentParams().as_array())
    assert np.array_equal(scores.astype(np.float32), want)


def test_metrics_report_host_chunks_on_cpu(tmp_path):
    from synth import standard_fixture

    from longtr_tpu.cli import main as cli_main

    fx = standard_fixture(str(tmp_path))
    metrics = str(tmp_path / "m.json")
    assert cli_main(["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
                     "--regions", fx["bed"], "--min-reads", "5", "--quiet",
                     "--tr-vcf", str(tmp_path / "o.vcf.gz"),
                     "--metrics-out", metrics]) == 0
    with open(metrics) as fh:
        m = json.load(fh)
    assert m["host_chunks"] > 0 and m["device_chunks"] == 0


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax-cache"])
def test_compile_cache_dir(monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert placement.compile_cache_dir() == os.path.join(root,
                                                             ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert placement.compile_cache_dir() is None


@pytest.mark.parametrize("platforms,cards,n,want", [
    ("cpu", "0,1,2,3", 3, [None, None, None]),
    ("", "0,1,2,3", 4, ["0", "1", "2", "3"]),
    ("cuda", "2,5", 2, ["2", "5"]),
    ("", "", 2, [None, None]),
    ("", "0,1,2,3", 5, "refused"),
])
def test_worker_envs(platforms, cards, n, want):
    environ = {"CUDA_VISIBLE_DEVICES": cards, "PATH": "/usr/bin"}
    if platforms:
        environ["JAX_PLATFORMS"] = platforms
    if want == "refused":
        with pytest.raises(ValueError, match="needs 5 GPUs, but 4"):
            placement.worker_envs(n, environ)
        return
    envs = placement.worker_envs(n, environ)
    assert len(envs) == n
    for env, card in zip(envs, want):
        if card is None:
            assert env == environ
        else:
            assert env["CUDA_VISIBLE_DEVICES"] == card
            assert env["PATH"] == "/usr/bin"


@pytest.mark.parametrize("width,want", [
    (1, (32, 8, 1)), (192, (32, 8, 1)), (256, (32, 8, 1)),
    (257, (64, 8, 1)), (4096, (256, 16, 1)), (8192, (512, 16, 1)),
    (8193, (512, 16, 2)), (40960, (512, 16, 5)),
])
def test_cuda_launch_shape(width, want):
    """The smallest compiled block shape covers the read; wider reads walk
    in segments, and only they get a scratch row per pair."""
    from longtr_tpu.ops import pairhmm_cuda
    threads, cols, nseg = pairhmm_cuda.launch_shape(width)
    assert (threads, cols, nseg) == want
    assert (threads, cols) in pairhmm_cuda.SHAPES
    assert nseg * threads * cols >= width
    assert pairhmm_cuda.scratch_len(7, width) == (
        7 * 3 * nseg * threads * cols if nseg > 1 else 1)


def test_cuda_build_flags():
    """Hopper's own target, and no FMA contraction (bit-identity)."""
    from longtr_tpu.ops import pairhmm_cuda
    cmd = pairhmm_cuda.build_command("/tmp/out.so")
    assert "--fmad=false" in cmd
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[cmd.index("-o") + 1] == "/tmp/out.so"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_gpu_path_matches_references(gpu, case):
    batch, params = _batch(case)
    got = np.asarray(pairhmm.pairhmm_device(*batch, params))
    _check_against_references(got, batch, params)


@pytest.mark.gpu
def test_gpu_scoring_runs_on_the_card(gpu):
    assert placement.pairhmm_route() == placement.DEVICE
    rng = np.random.default_rng(5)
    pairs = []
    for n in (60, 200, 2000):
        hap = "".join(rng.choice(BASES, n))
        pairs.append((hap, hap[5:], n + 60))
    handle = seq_genotyper.score_pairs_async(pairs)
    scores = handle.result()
    assert (handle.n_device, handle.n_host) == (3, 0)
    H, hl, R, rl, fl = _stack([p[0] for p in pairs], [p[1] for p in pairs])
    want = native.pairhmm_batch_native(H, hl, R, rl, fl,
                                       AlignmentParams().as_array())
    assert np.array_equal(scores.astype(np.float32), want)

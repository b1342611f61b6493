"""Smoke test of longtr on one NVIDIA GPU, through the normal entry points.

    python chip_smoke.py              # one card: phases 0-5
    python chip_smoke.py --devices 4  # the 4-card mesh path and its
                                      # one-card comparison, nothing else

All inputs are generated from fixed seeds.  Phases (one card):

0. device: the card, JAX, and the native and CUDA libraries built;
1. pair-HMM kernel level: the XLA scan and the CUDA kernel at B=2048 x
   192x192, B=128 x 8192x8192 and B=4 x 40960x40960, each equal to the
   native scorer bit for bit; 64 short pairs against the f64 oracle;
2. a short-STR catalog through ``longtr`` (300 loci x 3 samples x 20x);
3. a VNTR catalog (60 loci, 500-3000 bp repeats x 3 samples x 20x);
   phases 2 and 3 score every chunk on the card and write a VCF that is
   byte-identical (apart from ``##command``) to a CPU-backend run;
4. mode B (``--stutter-align-len 25``) on a homopolymer catalog: device
   pool scores within f32 drift of the f64 host scores, equal genotypes;
5. the tests marked ``gpu``.

Every number is printed next to the card's name and power limit.  The
last line is one JSON object naming the device JAX used.  The parent
process never starts JAX: each phase that needs the card runs in a child,
so one process holds the card at a time.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = None   # "name, power limit" of the first card, as nvidia-smi says


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0].strip()


def say(msg: str):
    print(f"[{CARD}] {msg}", flush=True)


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def vcf_body(path: str) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [ln for ln in fh if not ln.startswith("##command")]


def child(fn: str, *args, env=None, timeout=1100) -> dict:
    """Run ``chip_smoke.<fn>(*args)`` in a fresh interpreter; return the
    JSON report it prints last."""
    code = f"import chip_smoke as c; c.{fn}(*{list(args)!r})"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, text=True, timeout=timeout)
    lines = proc.stdout.rstrip("\n").splitlines()
    for ln in lines[:-1]:
        print(ln, flush=True)
    if proc.returncode != 0 or not lines:
        fail(f"{fn} exited with {proc.returncode}")
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# Phases that run on the card (in a child process)
# ---------------------------------------------------------------------------

def _device_report() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _random_batch(rng, B, N, M):
    """HiFi-like pairs: haplotypes of 90-100% of N, reads with 0.5%
    substitutions and 0.2% deletions, cut to M."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    H = np.zeros((B, N), np.uint8)
    R = np.zeros((B, M), np.uint8)
    hl = np.zeros(B, np.int32)
    rl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(int(0.9 * N), N + 1))
        hap = bases[rng.integers(0, 4, n)]
        read = hap[rng.random(n) >= 0.002].copy()
        sub = rng.random(len(read)) < 0.005
        read[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
        read = read[:M]
        H[b, :n] = hap
        R[b, :len(read)] = read
        hl[b], rl[b] = n, len(read)
    return H, hl, R, rl, hl + 60


def _timed(fn, args, reps=5):
    """(result, first-call seconds, median of ``reps`` synced calls)."""
    import numpy as np
    t0 = time.perf_counter()
    out = fn(*args)
    out.block_until_ready()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    return np.asarray(out), first, float(np.median(times))


def phase_kernel():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from longtr_tpu import native
    from longtr_tpu.ops import pairhmm
    from longtr_tpu.ops.pairhmm_cuda import pairhmm_cuda_jit

    params = pairhmm.AlignmentParams()
    trans = params.as_array()
    rng = np.random.default_rng(2024)
    for B, L in ((2048, 192), (128, 8192), (4, 40960)):
        H, hl, R, rl, fl = _random_batch(rng, B, L, L)
        t0 = time.perf_counter()
        want = native.pairhmm_batch_native(H, hl, R, rl, fl, trans)
        t_native = time.perf_counter() - t0
        d2d, i2i = pairhmm.ramps(trans, L, L)
        dev = [jax.device_put(jnp.asarray(a)) for a in
               (H, hl, R, rl, fl, trans, d2d, i2i)]
        useful = float(np.dot(hl.astype(np.int64), rl.astype(np.int64)))
        padded = float(B) * L * L
        for name, fn, args in (
                ("xla-scan", pairhmm._pairhmm_scan_jit, dev),
                ("cuda-kernel", pairhmm_cuda_jit, dev[:6])):
            got, first, t = _timed(fn, args)
            check(np.array_equal(got, want),
                  f"{name} B={B} L={L}: differs from the native scorer at "
                  f"{int((got != want).sum())} of {B} pairs")
            say(f"phase1 {name} B={B} {L}x{L}: bit-identical to native; "
                f"first call {first:.3f} s; median {t * 1e3:.3f} ms -> "
                f"{useful / t / 1e9:.2f} Gcells/s useful, "
                f"{padded / t / 1e9:.2f} Gcells/s padded")
        say(f"phase1 native host scorer B={B} {L}x{L}: {t_native:.3f} s "
            f"({useful / t_native / 1e9:.3f} Gcells/s)")

    # f64 oracle on short pairs (f32 drift only: rtol 5e-5, atol 2e-5)
    H, hl, R, rl, fl = _random_batch(rng, 64, 120, 120)
    got = np.asarray(pairhmm.pairhmm_device(H, hl, R, rl, fl, params))
    oracle = np.array([pairhmm.pairhmm_score_oracle(
        bytes(H[i, :hl[i]]).decode(), bytes(R[i, :rl[i]]).decode(), params,
        full_hap_len=int(fl[i])) for i in range(64)])
    sentinel = np.isin(oracle, (pairhmm.BAND_FAIL_SCORE,
                                pairhmm.IMPOSSIBLE))
    check(np.array_equal(got[sentinel], oracle[sentinel]),
          "oracle sentinels differ")
    check(np.allclose(got[~sentinel], oracle[~sentinel], rtol=5e-5,
                      atol=2e-5), "device path drifts from the f64 oracle")
    say(f"phase1 f64 oracle: 64 pairs within rtol 5e-5 / atol 2e-5; max "
        f"|diff| {np.abs(got - oracle).max():.3g}")


def _cli_args(fasta, bed, bams, out, metrics, extra=()):
    return (["--bams", ",".join(bams), "--fasta", fasta, "--regions", bed,
             "--tr-vcf", out, "--min-reads", "5", "--quiet",
             "--metrics-out", metrics] + list(extra))


def phase_catalog(tag, n_loci, vntr):
    """A catalog through ``longtr``: a CPU-backend run in a child process
    beside the first (compiling) GPU pass, then a timed second pass."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from loci_throughput import build_catalog, concordance

    from longtr_tpu.cli import main as cli_main
    from longtr_tpu.haplotype import poa

    tmp = tempfile.mkdtemp(prefix=f"smoke_{tag}_")
    t0 = time.perf_counter()
    fasta, bed, bams, loci, truth = build_catalog(tmp, n_loci, vntr=vntr)
    say(f"{tag}: {n_loci} loci x 3 samples x 20x built in "
        f"{time.perf_counter() - t0:.1f} s")
    extra = ["--max-tr-len", "10000"] if vntr else []
    cpu_out = os.path.join(tmp, "cpu.vcf.gz")
    cpu = subprocess.Popen(
        [sys.executable, "-m", "longtr_tpu.cli"]
        + _cli_args(fasta, bed, bams, cpu_out, os.path.join(tmp, "cpu.json"),
                    extra),
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    walls = []
    try:
        for r in (1, 2):
            poa._memo.clear()   # pass 2 redoes the per-locus work
            out = os.path.join(tmp, f"gpu{r}.vcf.gz")
            metrics = os.path.join(tmp, f"gpu{r}.json")
            if r == 2:
                check(cpu.wait() == 0, f"{tag}: CPU-backend run failed")
            t0 = time.perf_counter()
            check(cli_main(_cli_args(fasta, bed, bams, out, metrics,
                                     extra)) == 0,
                  f"{tag}: longtr pass {r} failed")
            walls.append(time.perf_counter() - t0)
            with open(metrics) as fh:
                m = json.load(fh)
            check(m["device_chunks"] > 0 and m["host_chunks"] == 0,
                  f"{tag}: pass {r} scored {m['device_chunks']} chunks on "
                  f"the device and {m['host_chunks']} on the host")
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    check(vcf_body(out) == vcf_body(cpu_out),
          f"{tag}: GPU VCF differs from the CPU-backend VCF")
    n_rec, n_gt, n_ok = concordance(out, loci, truth)
    stages = sorted(m["stage_seconds"].items(), key=lambda kv: -kv[1])
    say(f"{tag}: pass 1 (compiles) {walls[0]:.2f} s; pass 2 {walls[1]:.2f} s "
        f"-> {n_loci / walls[1]:.2f} loci/s; device chunks "
        f"{m['device_chunks']}, host chunks {m['host_chunks']}; VCF "
        f"byte-identical to the CPU backend; {n_rec}/{n_loci} records; "
        f"concordance {n_ok}/{n_gt} ({100.0 * n_ok / max(n_gt, 1):.1f}%)")
    say(f"{tag}: pass 2 stage seconds: "
        + "  ".join(f"{k}={v:.3f}" for k, v in stages[:8]))
    shutil.rmtree(tmp, ignore_errors=True)


def _homopolymer_catalog(tmp, n_loci=8, seed=7):
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import Locus, make_genome, write_bed, write_sample_bam

    from longtr_tpu.io.fasta import write_fasta
    rng = np.random.default_rng(seed)
    loci = [Locus(f"chr{i // 8 + 1}", (i % 8) * 1500 + 1000,
                  "AT"[i % 2], int(rng.integers(8, 20)), f"H{i}")
            for i in range(n_loci)]
    genome = make_genome(rng, loci, chrom_len=8 * 1500 + 2000)
    fasta = os.path.join(tmp, "g.fa")
    write_fasta(fasta, genome)
    bed = os.path.join(tmp, "r.bed")
    write_bed(bed, loci)
    bams = []
    for s in range(3):
        gts = {loc.name: (loc.ref_copies,
                          max(4, loc.ref_copies + int(rng.integers(-3, 4))))
               for loc in loci}
        path = os.path.join(tmp, f"S{s}.bam")
        write_sample_bam(path, genome, loci, gts, f"S{s}", rng, coverage=20,
                         sub_rate=0.002)
        bams.append(path)
    return fasta, bed, bams


def phase_mode_b():
    import numpy as np

    from longtr_tpu.cli import main as cli_main
    from longtr_tpu.pipeline.mode_b import ModeBAligner

    tmp = tempfile.mkdtemp(prefix="smoke_modeb_")
    fasta, bed, bams = _homopolymer_catalog(tmp)
    # pool score rows of each run in locus order, and how many the device
    # scored
    rows = {"device": [], "host": []}
    on_device = {"device": 0, "host": 0}
    side = "device"
    finish, score_read = (ModeBAligner.score_reads_batch_finish,
                          ModeBAligner.score_read)

    def rec_finish(self, prep):
        out = finish(self, prep)
        rows[side].extend(np.asarray(out, np.float64))
        on_device[side] += len(out)
        return out

    def rec_read(self, *a, **k):
        out = score_read(self, *a, **k)
        rows[side].append(np.asarray(out, np.float64))
        return out

    ModeBAligner.score_reads_batch_finish = rec_finish
    ModeBAligner.score_read = rec_read
    os.environ["LONGTR_SERIAL_BUILD"] = "1"   # both runs in locus order
    gts = {}
    try:
        for side in ("device", "host"):
            if side == "host":
                os.environ["LONGTR_MODE_B_HOST"] = "1"
            out = os.path.join(tmp, f"{side}.vcf.gz")
            t0 = time.perf_counter()
            check(cli_main(_cli_args(fasta, bed, bams, out,
                                     os.path.join(tmp, f"{side}.json"),
                                     ["--stutter-align-len", "25"])) == 0,
                  f"mode B {side} run failed")
            say(f"phase4 mode B {side} run: {time.perf_counter() - t0:.2f} s")
            gts[side] = [ln.split("\t")[:2] + [f.split(":")[0] for f in
                                               ln.rstrip().split("\t")[9:]]
                         for ln in vcf_body(out) if not ln.startswith("#")]
    finally:
        ModeBAligner.score_reads_batch_finish = finish
        ModeBAligner.score_read = score_read
        os.environ.pop("LONGTR_MODE_B_HOST", None)
        os.environ.pop("LONGTR_SERIAL_BUILD", None)
    check(on_device["device"] > 0 and on_device["host"] == 0,
          f"mode B rows scored on the device: {on_device}")
    check([r.shape for r in rows["device"]] == [r.shape for r in rows["host"]],
          "mode B runs scored different pools")
    dev = np.concatenate(rows["device"])
    host = np.concatenate(rows["host"])
    check(np.allclose(dev, host, rtol=1e-4, atol=1e-4),
          "mode B device pool scores drift from the f64 host scores")
    check(gts["device"] == gts["host"] and gts["device"],
          "mode B genotypes differ between device and host scoring")
    say(f"phase4 mode B: {len(rows['host'])} pool score rows within rtol 1e-4 / atol "
        f"1e-4 of the f64 host (max |diff| "
        f"{np.abs(dev - host).max():.3g}); {len(gts['device'])} records, "
        "genotypes equal")
    shutil.rmtree(tmp, ignore_errors=True)


def gpu_phases(phases=(1, 2, 3, 4)):
    """Phase 0 and then ``phases`` in one process on the card."""
    global CARD
    CARD = card_line()
    import jax

    from longtr_tpu import native, placement
    from longtr_tpu.ops import pairhmm_cuda

    say(f"phase0 jax {jax.__version__}; devices {jax.devices()}")
    check(jax.default_backend() == "gpu", "JAX found no GPU")
    placement.enable_compile_cache()
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "native library did not build")
    t1 = time.perf_counter()
    pairhmm_cuda.build()
    t2 = time.perf_counter()
    say(f"phase0 native library ready in {t1 - t0:.1f} s; CUDA kernel "
        f"library ready in {t2 - t1:.1f} s")
    if 1 in phases:
        phase_kernel()
    if 2 in phases:
        phase_catalog("phase2 short-STR", 300, vntr=False)
    if 3 in phases:
        phase_catalog("phase3 VNTR", 60, vntr=True)
    if 4 in phases:
        phase_mode_b()
    print(json.dumps(_device_report()), flush=True)


def gpu_tests():
    """Phase 5 as a child: the tests marked ``gpu``, on the card."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", "tests/test_device_path.py"],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cuda"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    tail = proc.stdout.strip().splitlines()[-1]
    check(proc.returncode == 0 and "skipped" not in tail,
          f"gpu tests: {tail}\n{proc.stdout[-4000:]}")
    return tail


# ---------------------------------------------------------------------------
# Four cards: the mesh path against one card
# ---------------------------------------------------------------------------

SURFACES = ("core", "snp-vcf", "em-training")


def mesh_surfaces(tmp, tag):
    """The core, snp-vcf and em-training surfaces through ``longtr`` on
    every visible card; VCFs go to ``tmp/<tag>_<surface>.vcf.gz``."""
    global CARD
    CARD = card_line()
    import jax

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from __graft_entry__ import _dryrun_catalog

    from longtr_tpu import placement
    from longtr_tpu.cli import main as cli_main

    check(jax.default_backend() == "gpu", "JAX found no GPU")
    fx_path = os.path.join(tmp, "fixture.json")
    if os.path.exists(fx_path):
        with open(fx_path) as fh:
            fx = json.load(fh)
    else:
        fx = _dryrun_catalog(tmp)
        with open(fx_path, "w") as fh:
            json.dump(fx, fh)
    n = len(jax.devices())
    say(f"{tag}: {n} device(s), mesh path {placement.use_mesh()}")
    base = ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--use-unpaired", "--min-reads", "5",
            "--quiet"]
    surfaces = {"core": [], "snp-vcf": ["--snp-vcf", fx["snp_vcf"]],
                "em-training": ["--no-def-stutter-model"]}
    for name in SURFACES:
        extra = surfaces[name]
        for _ in (1, 2):
            out = os.path.join(tmp, f"{tag}_{name}.vcf.gz")
            metrics = os.path.join(tmp, f"{tag}_{name}.json")
            t0 = time.perf_counter()
            check(cli_main(base + extra + ["--tr-vcf", out, "--metrics-out",
                                           metrics]) == 0,
                  f"{tag} {name}: longtr failed")
            wall = time.perf_counter() - t0
        with open(metrics) as fh:
            m = json.load(fh)
        check(m["device_chunks"] > 0 and m["host_chunks"] == 0,
              f"{tag} {name}: scoring left the device")
        say(f"{tag} {name}: {fx['n_loci']} loci, second pass {wall:.2f} s; "
            f"device chunks {m['device_chunks']}")
    print(json.dumps(_device_report()), flush=True)


def run_four_cards():
    cards = subprocess.run(["nvidia-smi", "--query-gpu=index",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.split()
    check(len(cards) >= 4, f"--devices 4 needs four cards, found {len(cards)}")
    tmp = tempfile.mkdtemp(prefix="smoke_mesh_")
    one = child("mesh_surfaces", tmp, "one-card",
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=cards[0]))
    four = child("mesh_surfaces", tmp, "four-card",
                 env=dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(cards[:4])))
    check(one["count"] == 1 and four["count"] == 4,
          f"device counts {one['count']} and {four['count']}")
    for name in SURFACES:
        a = vcf_body(os.path.join(tmp, f"one-card_{name}.vcf.gz"))
        b = vcf_body(os.path.join(tmp, f"four-card_{name}.vcf.gz"))
        check(a == b and len(a) > 0,
              f"{name}: the 4-card VCF differs from the one-card VCF")
        say(f"mesh {name}: 4-card VCF byte-identical to one card "
            f"({sum(not ln.startswith('#') for ln in a)} records)")
    shutil.rmtree(tmp, ignore_errors=True)
    return four


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the mesh path on four cards and the "
                         "one-card run it is compared with")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "longtr_tpu")):
        fail("run chip_smoke.py from a checkout of the repository")
    if shutil.which("nvidia-smi") is None:
        fail("no NVIDIA driver on this machine")
    CARD = card_line()
    if args.devices == 4:
        report = run_four_cards()
    else:
        report = child("gpu_phases")
        say(f"phase5 gpu tests: {gpu_tests()}")
    check(report["platform"] == "gpu", f"JAX ran on {report['platform']}")
    print(f"card: {CARD}", flush=True)
    print(json.dumps({"ok": True, "device": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end loci/s throughput on a synthetic catalog.

Builds an N-locus catalog (mixed STR/VNTR motifs and lengths) with
S samples at the given coverage, runs the full pipeline in-process
(single warm process — fresh-process start-up and compiles would dominate
otherwise) and reports loci/s plus the stage timing breakdown.

Modes: --vntr builds 500-3000bp repeats (device-dominant regime);
--ont injects 2% substitutions + 2% indels and the reference README's
raised-gap-open alignment params (BASELINE config 5).  Note the --ont
exact-genotype concordance (~56%) reflects the information limit of 4%
error on short motifs at 20x — candidate generation cannot separate
+/-1-copy alleles from indel noise — and is parameter-insensitive
(default vs raised-gap vs EM-learned stutter all land within 0.5%);
the run's purpose is robustness (all loci must still call cleanly).

--em drops the default stutter model so every locus trains one by EM
(--no-def-stutter-model --stutter-out); on a device mesh the whole
train loop runs device-side in one dispatch per locus
(parallel/mesh.em_train_sharded).

Usage: python benchmarks/loci_throughput.py [n_loci] [--cpu] [--vntr]
       [--ont] [--em] [--workers N] [--repeat N]
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))  # repo root: longtr_tpu without an editable install
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def build_catalog(tmpdir, n_loci, coverage=20, n_samples=3, seed=1,
                  vntr=False, ont=False):
    from synth import Locus, make_genome, write_bed, write_sample_bam
    from longtr_tpu.io.fasta import write_fasta
    rng = np.random.default_rng(seed)
    loci = []
    per_chrom = 8
    if vntr:
        # multi-kb VNTRs (500-3000bp repeats, 10-31bp motifs): the
        # device-dominant regime (BASELINE config 5 scale-up)
        vmotifs = ["ACGGTCATGG", "ACGGTCATGGACGGTCA",
                   "ACGGTCATGGACGGTCATGGACG",
                   "ACGGTCATGGACGGTCATGGACGGTCATGGA"]
        offset = 1000
        chrom_i = 1
        k = 0
        for i in range(n_loci):
            motif = vmotifs[i % len(vmotifs)]
            copies = int(rng.integers(500 // len(motif),
                                      3000 // len(motif)))
            loci.append(Locus(f"chr{chrom_i}", offset, motif, copies,
                              f"L{i}"))
            offset = loci[-1].stop + 900
            k += 1
            if k == per_chrom:
                k = 0
                chrom_i += 1
                offset = 1000
        chrom_len = max(l.stop for l in loci) + 1200
    else:
        motifs = ["AC", "AGAT", "CTG", "TTTA", "ACGGT", "A"]
        for i in range(n_loci):
            chrom = f"chr{i // per_chrom + 1}"
            offset = (i % per_chrom) * 1500 + 1000
            motif = motifs[i % len(motifs)]
            copies = int(rng.integers(8, 20)) if motif != "A" else int(rng.integers(10, 25))
            loci.append(Locus(chrom, offset, motif, copies, f"L{i}"))
        chrom_len = per_chrom * 1500 + 2000
    genome = make_genome(rng, loci, chrom_len=chrom_len)
    fasta = os.path.join(tmpdir, "g.fa")
    write_fasta(fasta, genome)
    bed = os.path.join(tmpdir, "r.bed")
    write_bed(bed, loci)
    bams = []
    truth = {}
    for s in range(n_samples):
        gts = {}
        for loc in loci:
            a = loc.ref_copies
            b = a + int(rng.integers(-3, 4))
            gts[loc.name] = (a, max(b, 2))
        path = os.path.join(tmpdir, f"S{s}.bam")
        write_sample_bam(path, genome, loci, gts, f"S{s}", rng,
                         coverage=coverage,
                         sub_rate=0.02 if ont else 0.002,
                         indel_rate=0.02 if ont else 0.0)
        bams.append(path)
        truth[f"S{s}"] = dict(gts)
    return fasta, bed, bams, loci, truth


def concordance(vcf_path, loci, truth_gts):
    """(records, genotyped samples, exact GB matches) of a VCF against the
    simulated genotypes (GB = bp differences from the reference)."""
    from longtr_tpu.io.bgzf import bgzf_open_text
    n_rec = 0
    n_gt = 0
    n_correct = 0
    samples = []
    loci_by_key = {l.name: l for l in loci}
    for ln in bgzf_open_text(vcf_path):
        if ln.startswith("##"):
            continue
        cols = ln.rstrip("\n").split("\t")
        if ln.startswith("#"):
            samples = cols[9:]
            continue
        n_rec += 1
        loc = loci_by_key.get(cols[2])
        if loc is None:
            continue
        fmt = cols[8].split(":")
        gb_i = fmt.index("GB")
        for si, samp in enumerate(samples):
            vals = cols[9 + si].split(":")
            if vals[0] == ".":
                continue
            n_gt += 1
            got = sorted(int(x) for x in vals[gb_i].split("|"))
            a, b = truth_gts[samp][loc.name]
            period = len(loc.motif)
            want = sorted(((a - loc.ref_copies) * period,
                           (b - loc.ref_copies) * period))
            if got == want:
                n_correct += 1
    return n_rec, n_gt, n_correct


def main():
    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    vntr = "--vntr" in sys.argv
    # --ont: BASELINE config 5 — high-error reads (2% subs + 2% indels)
    # with the raised-gap-open alignment params from the reference README
    ont = "--ont" in sys.argv
    em = "--em" in sys.argv
    workers = 1
    if "--workers" in sys.argv:
        workers = int(sys.argv[sys.argv.index("--workers") + 1])
    n_samples = 3
    if "--samples" in sys.argv:
        # cohort-scale mode: N BAMs / N samples through the multi-reader,
        # posterior, and VCF emission width
        n_samples = int(sys.argv[sys.argv.index("--samples") + 1])
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
        os.environ["JAX_PLATFORMS"] = "cpu"   # inherited by --workers subprocesses
    from longtr_tpu.placement import enable_compile_cache
    enable_compile_cache()

    tmpdir = tempfile.mkdtemp()
    print(f"building {n_loci}-locus{' VNTR' if vntr else ''} catalog...",
          flush=True)
    fasta, bed, bams, loci, truth_gts = build_catalog(
        tmpdir, n_loci, n_samples=n_samples, vntr=vntr, ont=ont)

    from longtr_tpu.cli import main as cli_main
    # --repeat N: run the same catalog N times in-process and report the
    # best pass.  Pass 1 pays one-time costs a long-lived service never
    # re-pays (compile-cache loads, jit tracing);
    # later passes measure steady-state throughput.
    repeat = 1
    if "--repeat" in sys.argv:
        repeat = int(sys.argv[sys.argv.index("--repeat") + 1])
    out = metrics_path = dt = None
    for r in range(repeat):
        if r:
            # --repeat amortizes one-time COMPILE/trace costs only: clear
            # data-keyed caches so later passes still pay the per-locus
            # work a fresh catalog would (the POA memo is keyed on cluster
            # members and would otherwise skip assembly on pass 2+) —
            # same discipline as real_data_smoke.py
            from longtr_tpu.haplotype import poa
            poa._memo.clear()
        out = os.path.join(tmpdir, f"calls{r}.vcf.gz")
        metrics_path = os.path.join(tmpdir, f"metrics{r}.json")
        t0 = time.time()
        rc = cli_main(["--bams", ",".join(bams), "--fasta", fasta,
                       "--regions", bed, "--tr-vcf", out,
                       "--min-reads", "5", "--quiet",
                       "--metrics-out", metrics_path]
                      + (["--max-tr-len", "10000"] if vntr else [])
                      + (["--alignment-params=-1.5,-0.3,-1.5,-0.3,"
                          "-0.0001,-8.0,-8.0", "--max-tr-len", "1000"]
                         if ont and not vntr else [])
                      + (["--no-def-stutter-model", "--stutter-out",
                          os.path.join(tmpdir, f"stutter{r}.txt")]
                         if em else [])
                      + (["--workers", str(workers)] if workers > 1 else []))
        dt_r = time.time() - t0
        assert rc == 0
        print(f"pass {r + 1}/{repeat}: {dt_r:.1f}s "
              f"-> {n_loci / dt_r:.1f} loci/s", flush=True)
        dt = dt_r if dt is None else min(dt, dt_r)
    import json
    m = json.load(open(metrics_path))
    print(f"device chunks: {m.get('device_chunks')}  "
          f"host chunks: {m.get('host_chunks')}  "
          f"host syncs: {m.get('num_syncs')}")
    stages = sorted(m.get("stage_seconds", {}).items(),
                    key=lambda kv: -kv[1])
    print("stage seconds: " +
          "  ".join(f"{k}={v:.2f}" for k, v in stages[:8]))
    n_rec, n_gt, n_correct = concordance(out, loci, truth_gts)
    print(f"records: {n_rec}/{n_loci}")
    print(f"genotype concordance: {n_correct}/{n_gt} "
          f"({100.0 * n_correct / max(n_gt, 1):.1f}%)")
    print(f"wall: {dt:.1f}s -> {n_loci / dt:.1f} loci/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chromosome-scale run: shard / checkpoint / resume / merge at catalog scale.

Exercises BASELINE config 4 (whole-chromosome scale): an N-locus synthetic
catalog (default 100k, chr1-scale) processed as ``--shard i/S`` slices with
``--checkpoint`` ledgers, a mid-run interruption + resume on shard 0, and a
final ``longtr-merge-vcf`` merge.  Records loci/s, peak RSS, device
dispatches/syncs, and asserts the interrupted+resumed shard is byte-identical
to a fresh run of the same shard.

Usage: python benchmarks/scale_run.py [n_loci] [--cpu] [--shards S]
"""

import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))  # repo root: longtr_tpu without an editable install
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.dirname(__file__))

from loci_throughput import build_catalog  # noqa: E402


def peak_rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


from synth import vcf_body  # noqa: E402


def main():
    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 100000
    n_shards = 4
    if "--shards" in sys.argv:
        n_shards = int(sys.argv[sys.argv.index("--shards") + 1])
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from longtr_tpu.placement import enable_compile_cache
    enable_compile_cache()

    tmpdir = tempfile.mkdtemp()
    t0 = time.time()
    print(f"building {n_loci}-locus catalog...", flush=True)
    fasta, bed, bams, loci, _truth = build_catalog(
        tmpdir, n_loci, coverage=12, n_samples=1)
    print(f"catalog built in {time.time() - t0:.1f}s "
          f"(RSS {peak_rss_mb():.0f} MB)", flush=True)

    from longtr_tpu.cli import main as cli_main
    from longtr_tpu.parallel.multihost import merge_sorted_vcfs

    base = ["--bams", ",".join(bams), "--fasta", fasta, "--regions", bed,
            "--min-reads", "5", "--quiet"]

    # ---- shard 0: interrupted run + checkpoint resume -------------------
    # Simulate an interruption by first processing only half of shard 0's
    # catalog (truncated BED), then resuming over the full BED with the
    # same checkpoint ledger.
    # The truncated BED must be a PREFIX of the catalog in processing order
    # (regions sort by (chrom, start) — lexicographic chrom, regions.py:48),
    # so that shard 0 of the half catalog is a subset of shard 0 of the
    # full catalog under either shard mode.  Truncating by file order only
    # worked for interleave by accident (8 loci/chrom, divisible by the
    # shard count).
    half_bed = os.path.join(tmpdir, "half.bed")
    with open(bed) as src, open(half_bed, "w") as dst:
        lines = sorted(src.readlines(),
                       key=lambda ln: (ln.split("\t")[0],
                                       int(ln.split("\t")[1])))
        dst.writelines(lines[: len(lines) // 2])
    ckpt = os.path.join(tmpdir, "shard0.ckpt")
    part1 = os.path.join(tmpdir, "shard0_part1.vcf.gz")
    t0 = time.time()
    assert cli_main(["--bams", ",".join(bams), "--fasta", fasta,
                     "--regions", half_bed, "--min-reads", "5", "--quiet",
                     "--tr-vcf", part1, "--shard", f"0/{n_shards}", "--shard-mode", "block",
                     "--checkpoint", ckpt]) == 0
    n_done = len(open(ckpt).read().splitlines())
    print(f"shard0 interrupted after {n_done} loci "
          f"({time.time() - t0:.1f}s)", flush=True)
    part2 = os.path.join(tmpdir, "shard0_part2.vcf.gz")
    t0 = time.time()
    assert cli_main(base + ["--tr-vcf", part2, "--shard", f"0/{n_shards}", "--shard-mode", "block",
                            "--checkpoint", ckpt]) == 0
    print(f"shard0 resumed ({time.time() - t0:.1f}s)", flush=True)
    resumed = os.path.join(tmpdir, "shard0_resumed.vcf.gz")
    merge_sorted_vcfs([part1, part2], resumed)

    # ---- all shards fresh, timed ----------------------------------------
    shard_paths = []
    metrics_total = {"device_chunks": 0, "host_chunks": 0, "num_syncs": 0}
    t_all = time.time()
    for i in range(n_shards):
        out = os.path.join(tmpdir, f"shard{i}.vcf.gz")
        mpath = os.path.join(tmpdir, f"m{i}.json")
        t0 = time.time()
        assert cli_main(base + ["--tr-vcf", out, "--shard",
                                f"{i}/{n_shards}", "--shard-mode", "block",
                                "--metrics-out", mpath]) == 0
        m = json.load(open(mpath))
        metrics_total["device_chunks"] += m.get("device_chunks", 0)
        metrics_total["host_chunks"] += m.get("host_chunks", 0)
        metrics_total["num_syncs"] += m.get("num_syncs", 0)
        print(f"shard {i}/{n_shards}: {m['num_genotype_success']} loci in "
              f"{time.time() - t0:.1f}s "
              f"(device chunks {m.get('device_chunks')}, "
              f"syncs {m.get('num_syncs')})", flush=True)
        shard_paths.append(out)
    dt_all = time.time() - t_all

    merged = os.path.join(tmpdir, "merged.vcf.gz")
    t0 = time.time()
    merge_sorted_vcfs(shard_paths, merged)
    t_merge = time.time() - t0

    # ---- validation -----------------------------------------------------
    assert vcf_body(resumed) == vcf_body(shard_paths[0]), \
        "checkpoint-resumed shard differs from fresh shard"
    n_rec = sum(1 for ln in vcf_body(merged) if not ln.startswith("#"))

    print(f"\n==== scale run summary ({n_loci} loci, {n_shards} shards) ====")
    print(f"records merged: {n_rec}")
    print(f"genotyping wall (all shards, sequential): {dt_all:.1f}s "
          f"-> {n_loci / dt_all:.1f} loci/s")
    print(f"merge wall: {t_merge:.2f}s")
    print(f"peak RSS: {peak_rss_mb():.0f} MB")
    print(f"device chunks: {metrics_total['device_chunks']}  "
          f"host chunks: {metrics_total['host_chunks']}  "
          f"host syncs: {metrics_total['num_syncs']}")
    print("checkpoint-resume: byte-identical to fresh shard run")
    return 0


if __name__ == "__main__":
    sys.exit(main())

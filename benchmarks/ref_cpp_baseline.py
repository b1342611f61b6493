"""Single-core compiled-REFERENCE genotyping baseline (loci/s).

The reference binary is unbuildable in this snapshot (htslib/spoa are
Makefile network clones, BASELINE.md), but tests/ref_oracle compiles the
reference's own genotyping chain from /root/reference/src in place:
seq_stutter_genotyper.cpp ctor -> genotype() -> write_vcf_record, with
the real HaplotypeGenerator, HapAligner and posterior underneath.  This
benchmark captures the production pipeline's per-locus genotyper inputs
on a workload and replays them through that compiled chain, timing ONLY
the C++ execution (the ctypes marshalling is excluded by patching the
call shim) — the closest measurable analog of "single-threaded reference
loci/s" available here.

What it EXCLUDES: the reference's BAM seek/decode, read filtering and
trimming (the pipeline stages before the genotyper).  The measured
number is therefore an UPPER bound on the reference binary's throughput
— comparisons against our end-to-end loci/s favor the reference.

Loci whose replay hits the oracle's deliberate spoa-sampling stub
(clusters >= 30, HaplotypeGenerator.cpp:182-192) are dropped from both
the numerator and the accumulated wall.

Usage: python benchmarks/ref_cpp_baseline.py [trio|vntr|short] [n_loci]
       (pin with `taskset -c 0` for a strict single-core reading; the
       compiled chain is single-threaded regardless, reference
       README.md:79)
"""

import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def capture_and_replay(bams, fasta, bed, extra_args=()):
    """Run the production CLI with genotyper-construction capture, then
    replay every captured locus through the compiled reference chain.
    Returns (n_timed_loci, cpp_seconds, n_skipped)."""
    import tests.ref_oracle as ro

    import longtr_tpu.pipeline.processor as proc
    from longtr_tpu.cli import main as cli_main

    captured = []
    real = proc.SeqStutterGenotyper

    class Spy(real):
        def __init__(self, group, haploid, alns, p1s, p2s, n_p1s, n_p2s,
                     sample_names, chrom_seq, stutter_models, **kw):
            captured.append(dict(
                group=group, haploid=haploid, alns=list(alns),
                p1s=[list(x) for x in p1s], p2s=[list(x) for x in p2s],
                n_p1s=list(n_p1s), n_p2s=list(n_p2s),
                sample_names=list(sample_names), chrom_seq=chrom_seq,
                stutter=stutter_models[0],
                skip_assembly=kw.get("skip_assembly", True),
                indel_flank_len=kw.get("indel_flank_len", 5),
                switch_old_align_len=kw.get("switch_old_align_len", 0),
                alignment_params=kw.get("alignment_params")))
            super().__init__(group, haploid, alns, p1s, p2s, n_p1s, n_p2s,
                             sample_names, chrom_seq, stutter_models, **kw)

    proc.SeqStutterGenotyper = Spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "calls.vcf.gz")
            rc = cli_main(["--bams", ",".join(bams), "--fasta", fasta,
                           "--regions", bed, "--tr-vcf", out,
                           "--min-reads", "5", "--quiet", "--ref-fidelity"]
                          + list(extra_args))
            assert rc == 0
    finally:
        proc.SeqStutterGenotyper = real
    assert captured, "no loci captured"

    # time ONLY the compiled-reference call, not the ctypes marshalling
    acc = [0.0]
    orig = ro._call_genotype_locus

    def timed(*a, **k):
        t0 = time.perf_counter()
        r = orig(*a, **k)
        acc[0] += time.perf_counter() - t0
        return r

    ro._call_genotype_locus = timed
    ro.set_genotyper_flags(allreads=1, mallreads=1)
    n_timed = n_skipped = 0
    try:
        for cap in captured:
            region = cap["group"].regions[0]
            sm = cap["stutter"]
            reads = []
            flat = iter(cap["alns"])
            for s, p1_list in enumerate(cap["p1s"]):
                rd = []
                for j in range(len(p1_list)):
                    a = next(flat)
                    rd.append(dict(
                        seq=a.sequence, quals=a.base_qualities,
                        aln=a.alignment, name=a.name, start=a.start,
                        stop=a.stop, rev=a.rev_strand, deleted=a.deleted,
                        use_for_haps=(bool(a.use_for_haps)
                                      and a.use_for_haps[0]),
                        cigar="".join(f"{n}{op}" for op, n in a.cigar),
                        log_p1=p1_list[j], log_p2=cap["p2s"][s][j]))
                reads.append(rd)
            before = acc[0]
            try:
                ro.genotype_locus(
                    cap["chrom_seq"], region.chrom, region.start,
                    region.stop, region.motif, reads, cap["sample_names"],
                    (sm.in_geom, sm.in_up, sm.in_down,
                     sm.out_geom, sm.out_up, sm.out_down),
                    haploid=cap["haploid"], n_p1s=cap["n_p1s"],
                    n_p2s=cap["n_p2s"],
                    skip_assembly=cap["skip_assembly"],
                    indel_flank_len=cap["indel_flank_len"],
                    switch_old_align_len=cap["switch_old_align_len"],
                    aln_params=cap["alignment_params"],
                    vcf_sample_names=cap["sample_names"],
                    region_name=region.name or "")
                n_timed += 1
            except AssertionError as e:
                if "spoa stub" in str(e):
                    acc[0] = before     # partial work: drop the locus
                    n_skipped += 1
                    continue
                raise
    finally:
        ro._call_genotype_locus = orig
    return n_timed, acc[0], n_skipped


def main():
    workload = sys.argv[1] if len(sys.argv) > 1 else "trio"
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    from longtr_tpu.placement import enable_compile_cache
    enable_compile_cache()

    if workload == "trio":
        # fixture + option set come from the ONE shared definition so the
        # ref-vs-ours comparison always runs the identical configuration
        from real_data_smoke import TRIO_ARGS, build_trio_fixture
        n_loci = int(sys.argv[2]) if len(sys.argv) > 2 else 40
        tmp = tempfile.mkdtemp()
        bams, fasta, bed = build_trio_fixture(tmp, n_loci)
        extra = list(TRIO_ARGS)
    else:
        from loci_throughput import build_catalog
        n_loci = int(sys.argv[2]) if len(sys.argv) > 2 else (
            12 if workload == "vntr" else 100)
        tmp = tempfile.mkdtemp()
        fasta, bed, bams, _loci, _truth = build_catalog(
            tmp, n_loci, vntr=(workload == "vntr"))
        extra = ["--max-tr-len", "10000"] if workload == "vntr" else []

    print(f"capturing {n_loci}-locus {workload} workload and replaying "
          "through the compiled reference...", flush=True)
    n, cpp_s, skipped = capture_and_replay(bams, fasta, bed, extra)
    print(f"compiled reference genotyping chain: {n} loci in {cpp_s:.2f}s "
          f"C++ wall ({skipped} spoa-stub skips)")
    print(f"ref_cpp: {n / cpp_s:.3f} loci/s (single core, genotyping "
          "stage only — excludes reference BAM IO/filtering)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Real-data smoke run: the reference's bundled HG002/HG003/HG004 HiFi trio.

The bundled test_data (reference repo) lacks hg38.analysisSet.fa, so the
reference sequence over each catalog window is reconstructed from the reads
themselves by pileup majority vote (hom-alt sites bake the alt into the
estimate — fine for a smoke run; the point is exercising the full pipeline
on real 10-25kb HiFi reads: real base qualities, real error profile, real
HP phasing tags, the 7-column HipSTR BED, and the job.sh option set).

Usage: python benchmarks/real_data_smoke.py [n_loci] [--cpu]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))  # repo root: longtr_tpu without an editable install

TEST_DATA = "/root/reference/test_data"

# the reference's own job.sh option set for the bundled trio — the ONE
# definition shared by the smoke run, the golden-VCF generator
# (tests/golden/regen_trio.py) and the compiled-reference baseline
# (benchmarks/ref_cpp_baseline.py): the ref-vs-ours comparisons are only
# meaningful if every consumer runs the identical configuration
TRIO_ARGS = ["--bam-samps", "HG002,HG003,HG004",
             "--bam-libs", "HG002,HG003,HG004",
             "--max-tr-len", "10000", "--skip-assembly", "--phased-bam"]


def build_trio_fixture(outdir, n_loci=40):
    """Bundled-trio fixture: BAM paths, a pileup-estimated reference over
    the first ``n_loci`` BED windows, and the sliced BED.  Returns
    (bams, fasta, bed)."""
    from longtr_tpu.io.fasta import write_fasta

    bams = [os.path.join(TEST_DATA, f"HG00{i}_sample_reads.bam")
            for i in (2, 3, 4)]
    bed_in = os.path.join(TEST_DATA, "test_regions_hg38.bed")
    with open(bed_in) as fh:
        lines = fh.readlines()[:n_loci]
    loci = [(f[0], int(f[1]), int(f[2])) for f in (l.split() for l in lines)]
    genome = reconstruct_reference(bams, loci, None)
    fasta = os.path.join(outdir, "est_ref.fa")
    write_fasta(fasta, genome)
    bed = os.path.join(outdir, "regions.bed")
    with open(bed, "w") as fh:
        fh.writelines(lines)
    return bams, fasta, bed


def reconstruct_reference(bams, bed_loci, chrom_len, pad=700):
    """Majority-vote reference estimate over each catalog window."""
    import numpy as np

    from longtr_tpu.io.bam import BamReader

    windows = []
    for chrom, start, stop in bed_loci:
        windows.append((chrom, max(start - pad, 0), stop + pad))
    # merge overlapping windows
    windows.sort()
    merged = []
    for c, s, e in windows:
        if merged and merged[-1][0] == c and s <= merged[-1][2]:
            merged[-1] = (c, merged[-1][1], max(merged[-1][2], e))
        else:
            merged.append((c, s, e))

    lut = np.full(256, -1, dtype=np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    for i, b in enumerate(b"acgt"):
        lut[b] = i
    bases_u8 = np.frombuffer(b"ACGT", dtype=np.uint8)
    readers = [BamReader(p) for p in bams]  # reuse decode windows
    spans = {}  # chrom -> list of (start, estimated seq string)
    for chrom, s, e in merged:
        counts = np.zeros((e - s, 4), dtype=np.int32)
        for r in readers:
            if not r.set_region(chrom, s, e):
                continue
            while (rec := r.get_next_alignment()) is not None:
                rpos = rec.pos
                qpos = 0
                codes = lut[np.frombuffer(rec.seq.encode(), dtype=np.uint8)]
                for op, n in rec.cigar:
                    if op in "M=X":
                        lo = max(s, rpos)
                        hi = min(e, rpos + n)
                        if hi > lo:
                            q0 = qpos + (lo - rpos)
                            cs = codes[q0: q0 + (hi - lo)]
                            idx = np.arange(lo - s, hi - s)
                            ok = cs >= 0
                            np.add.at(counts, (idx[ok], cs[ok]), 1)
                        rpos += n
                        qpos += n
                    elif op in "DN":
                        rpos += n
                    elif op in "IS":
                        qpos += n
        est = bases_u8[counts.argmax(axis=1)]
        est[counts.sum(axis=1) == 0] = ord("N")
        spans.setdefault(chrom, []).append((s, est.tobytes().decode()))
    # materialize sparse chromosomes (merged spans are sorted, disjoint)
    out = {}
    for chrom, sp in spans.items():
        parts = []
        cur = 0
        for s, seq in sp:
            parts.append("N" * (s - cur))
            parts.append(seq)
            cur = s + len(seq)
        out[chrom] = "".join(parts)
    return out


def main():
    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from longtr_tpu.placement import enable_compile_cache
    enable_compile_cache()

    tmp = os.environ.get("SMOKE_OUT_DIR") or tempfile.mkdtemp()
    os.makedirs(tmp, exist_ok=True)
    print(f"reconstructing reference over {n_loci} windows...", flush=True)
    bams, fasta, bed = build_trio_fixture(tmp, n_loci)
    with open(bed) as fh:
        loci = [ln for ln in fh]

    from longtr_tpu.cli import main as cli_main
    # --repeat N: best pass of N (pass 1 pays one-time compile / trace
    # costs; steady state is what a long-lived service sees)
    repeat = 1
    if "--repeat" in sys.argv:
        repeat = int(sys.argv[sys.argv.index("--repeat") + 1])
    out = dt = None
    for r in range(repeat):
        if r:
            # --repeat amortizes one-time COMPILE/trace costs only: clear
            # data-level caches so later passes still pay the per-locus
            # work a fresh catalog would (POA memo keyed on cluster
            # members would otherwise skip assembly entirely on pass 2+)
            from longtr_tpu.haplotype import poa
            poa._memo.clear()
        out = os.path.join(tmp, f"trio{r}.vcf.gz")
        t0 = time.time()
        rc = cli_main(["--bams", ",".join(bams), "--fasta", fasta,
                       "--regions", bed, "--tr-vcf", out,
                       "--min-reads", "5", "--quiet"] + TRIO_ARGS)
        dt_r = time.time() - t0
        assert rc == 0
        if repeat > 1:
            print(f"pass {r + 1}/{repeat}: {dt_r:.1f}s "
                  f"-> {len(loci) / dt_r:.2f} loci/s", flush=True)
        dt = dt_r if dt is None else min(dt, dt_r)
    from longtr_tpu.io.bgzf import bgzf_open_text
    n_rec = 0
    n_called = 0
    for ln in bgzf_open_text(out):
        if ln.startswith("#"):
            continue
        n_rec += 1
        cols = ln.split("\t")
        n_called += sum(1 for c in cols[9:] if not c.startswith("."))
    print(f"records: {n_rec}/{len(loci)}  sample-calls: {n_called}")
    print(f"wall: {dt:.1f}s -> {len(loci) / dt:.2f} loci/s", flush=True)

    # Mendelian-consistency validation: HG002 is the child of HG003
    # (father) and HG004 (mother) — the only truth check available without
    # external benchmarks (machinery: denovo/pedigree.py, reference analog
    # src/pedigree.cpp:71-88).  Child alleles must be drawable one from
    # each parent at every fully-called locus.
    from longtr_tpu.denovo.pedigree import NuclearFamily
    from longtr_tpu.io.vcf import VCFReader

    fam = NuclearFamily("trio", mother="HG004", father="HG003",
                        children=["HG002"])
    reader = VCFReader(out)
    n_full = n_mendel = 0
    for chrom in reader.chromosomes():
        reader.set_region(chrom, 0)
        while (var := reader.get_next_variant()) is not None:
            if fam.is_missing_genotype(var):
                continue
            n_full += 1
            if fam.is_mendelian(var):
                n_mendel += 1
    rate = n_mendel / n_full if n_full else 0.0
    print(f"mendelian: {n_mendel}/{n_full} fully-called loci "
          f"({100 * rate:.1f}%)", flush=True)
    # Threshold: de novo TR mutation rates are ~1e-4/locus; residual
    # discordance here reflects genotyping errors (plus the majority-vote
    # reference estimate).  The 3 known-inconsistent loci on the bundled
    # trio are each explained (README "Mendelian validation": one
    # GLDIFF=0.00 tie-broken low-depth VNTR call, two reference-faithful
    # homopolymer stutter het-overcalls), setting the explained rate at
    # 35/38 = 0.921 on the full 40-locus BED; the gate fails below 0.9.
    assert n_full >= min(5, n_rec), "too few fully-called trio loci"
    assert rate >= 0.9, f"Mendelian consistency {rate:.2f} below threshold"
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Randomized record-parity campaign vs the compiled reference.

Long-running differential fuzz over the PRODUCTION pipeline: random
catalogs (motif mix / VNTR scale, coverage, sample count, read error
rate, haploid chroms, custom alignment params) run through the CLI in
fidelity mode with every SeqStutterGenotyper construction captured and
replayed through the compiled reference chain
(tests/test_pipeline_record_parity.py machinery); every emitted record
must match byte for byte.  Any divergence is a real bug — this harness
found the left-align cross-element CIGAR-merge divergence in round 3.

Usage: python benchmarks/parity_campaign.py [n_trials] [start_seed]
Prints one line per trial; exits nonzero on the first divergence with
the trial's full config for reproduction.
"""

import os
import sys
import tempfile

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _ROOT)                               # tests.ref_oracle
sys.path.insert(0, os.path.join(_ROOT, "tests"))        # synth, test_*
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


class _Patch:
    """Minimal monkeypatch.setattr stand-in for the test helper."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, val in reversed(self._saved):
            setattr(obj, name, val)
        self._saved.clear()


def run_trial(seed: int) -> str:
    from pathlib import Path

    from loci_throughput import build_catalog
    from test_pipeline_record_parity import _run_and_compare

    rng = np.random.default_rng(seed)
    vntr = bool(rng.random() < 0.2)
    n_loci = int(rng.integers(3, 8)) if vntr else int(rng.integers(6, 26))
    coverage = int(rng.integers(8, 40))
    n_samples = int(rng.integers(1, 6))
    ont = bool(rng.random() < 0.25)
    haploid = bool(rng.random() < 0.2)
    custom_params = bool(rng.random() < 0.2)

    extra = []
    if vntr:
        extra += ["--max-tr-len", "10000"]
    if custom_params:
        g = -float(rng.uniform(6.0, 12.0))
        extra += [f"--alignment-params=-1.5,-0.3,-1.5,-0.3,-0.0001,{g},{g}"]
    phased = bool(rng.random() < 0.3)       # HP-tag phasing path
    if phased:
        extra += ["--phased-bam"]
    # --snp-vcf path (mutually exclusive with --phased-bam upstream):
    # SNP-tree factors from a synthesized phased SNP VCF, bit-checked
    # against compiled snp_tree.cpp + calc_het_snp_factors; optional --fam
    # adds pedigree filtering through the real HaplotypeTracker
    snp_vcf_mode = (not phased and not vntr and rng.random() < 0.25)
    fam_mode = snp_vcf_mode and n_samples >= 3 and rng.random() < 0.5
    outflags = []
    if rng.random() < 0.4:
        for fl in ("--output-gls", "--output-pls", "--output-phased-gls",
                   "--output-filters"):
            if rng.random() < 0.5:
                outflags.append(fl)
        extra += outflags
    desc = (f"seed={seed} loci={n_loci} cov={coverage} S={n_samples} "
            f"vntr={vntr} ont={ont} haploid={haploid} "
            f"params={custom_params} phased={phased} out={outflags}")

    tmpdir = tempfile.mkdtemp(prefix=f"parity{seed}_")
    if vntr:
        # clean reads at VNTR scale: errors route most loci into the POA
        # rescue path, which the oracle's spoa stub cannot replay — build
        # error-free cohorts so the multi-hundred-bp emission IS checked
        from longtr_tpu.io.fasta import write_fasta
        from synth import Locus, make_genome, write_bed, write_sample_bam
        motifs = ["ACGGTCATGG", "ACGGTCATGGACGGTCA",
                  "ACGGTCATGGACGGTCATGGACG"]
        loci = []
        offset = 1000
        for i in range(n_loci):
            m = motifs[int(rng.integers(0, len(motifs)))]
            copies = int(rng.integers(300 // len(m), 900 // len(m)))
            loci.append(Locus("chr1", offset, m, copies, f"V{i}"))
            offset = loci[-1].stop + 800
        genome = make_genome(rng, loci, chrom_len=offset + 1200)
        fasta = os.path.join(tmpdir, "g.fa")
        write_fasta(fasta, genome)
        bed = os.path.join(tmpdir, "r.bed")
        write_bed(bed, loci)
        bams = []
        for s in range(n_samples):
            gts = {l.name: (max(l.ref_copies + int(rng.integers(-2, 3)), 2),
                            max(l.ref_copies + int(rng.integers(-2, 3)), 2))
                   for l in loci}
            p = os.path.join(tmpdir, f"S{s}.bam")
            write_sample_bam(p, genome, loci, gts, f"S{s}", rng,
                             coverage=coverage)
            bams.append(p)
    else:
        fasta, bed, bams, _loci, _truth = build_catalog(
            tmpdir, n_loci, coverage=coverage, n_samples=n_samples,
            seed=seed, ont=ont)
    if haploid:
        chroms = sorted({ln.split()[0] for ln in open(bed)})
        extra += ["--haploid-chrs", ",".join(chroms)]
    if not vntr and rng.random() < 0.15:
        # --ref-vcf mode: a panel supplying ref + random alt alleles per
        # locus (replayed into the oracle via ro_set_ref_vcf_alleles)
        from longtr_tpu.io.bgzf import BgzfWriter
        from longtr_tpu.io.fasta import FastaReader
        fr = FastaReader(fasta)
        lines = ["##fileformat=VCFv4.1",
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
        for li, loc in enumerate(_loci):
            chrom_seq = fr.get_sequence(loc.chrom)
            ref_seq = chrom_seq[loc.start: loc.stop]
            alts = []
            for d in {int(rng.integers(-3, 4)) for _ in range(2)} - {0}:
                c = loc.ref_copies + d
                if c >= 1:
                    alts.append(loc.motif * c)
            if not alts:
                alts = [loc.motif * (loc.ref_copies + 1)]
            lines.append(
                f"{loc.chrom}\t{loc.start + 1}\t{loc.name}\t{ref_seq}\t"
                f"{','.join(alts)}\t.\t.\tSTART={loc.start + 1};"
                f"END={loc.stop};PERIOD={len(loc.motif)}")
        panel = os.path.join(tmpdir, "panel.vcf.gz")
        w = BgzfWriter(panel)
        w.write("\n".join(lines) + "\n")
        w.close()
        extra += ["--ref-vcf", panel]
        desc += " refvcf=True"

    if snp_vcf_mode:
        from longtr_tpu.io.bgzf import BgzfWriter
        from longtr_tpu.io.fasta import FastaReader
        samples = [f"S{s}" for s in range(n_samples)]
        fr = FastaReader(fasta)
        chroms = sorted({ln.split()[0] for ln in open(bed)},
                        key=lambda c: int(c[3:]))
        lines = ["##fileformat=VCFv4.1",
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(samples)]
        mh_pick, dh_pick = int(rng.integers(2)), int(rng.integers(2))
        for chrom in chroms:
            seq = fr.get_sequence(chrom)
            pos = 200
            while pos < len(seq) - 200:
                pos += int(rng.integers(30, 140))
                if pos >= len(seq) - 200:
                    break
                ref = seq[pos].upper()
                if ref not in "ACGT":
                    continue
                alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
                gts = {}
                for s in samples:
                    gts[s] = (int(rng.integers(2)), int(rng.integers(2)))
                if fam_mode:   # S0 = child of S1 (father) x S2 (mother)
                    gts["S0"] = (gts["S2"][mh_pick], gts["S1"][dh_pick])
                cols = "\t".join(f"{gts[s][0]}|{gts[s][1]}" for s in samples)
                lines.append(f"{chrom}\t{pos + 1}\tsnp{chrom}_{pos}\t{ref}\t"
                             f"{alt}\t.\t.\t.\tGT\t" + cols)
        snp_vcf = os.path.join(tmpdir, "snps.vcf.gz")
        w = BgzfWriter(snp_vcf)
        w.write("\n".join(lines) + "\n")
        w.close()
        extra += ["--snp-vcf", snp_vcf]
        if fam_mode:
            fam = os.path.join(tmpdir, "fam.fam")
            with open(fam, "w") as fh:
                fh.write("FAM1\tS0\tS1\tS2\n")
            extra += ["--fam", fam]
        desc += f" snpvcf=True fam={fam_mode}"

    patch = _Patch()
    skip_log = []
    try:
        n = _run_and_compare(Path(tmpdir), patch, bams, fasta, bed,
                             extra_args=extra, skip_log=skip_log)
    finally:
        patch.undo()
    # big-cluster rescue loci the oracle cannot replay (reference samples
    # clusters >= 30 with std::random_device, HaplotypeGenerator.cpp:182-192)
    # — reported so that coverage is measured, not silently assumed
    _SPOA_SKIPS["skipped"] += len(skip_log)
    _SPOA_SKIPS["checked"] += n
    note = f" spoa-skips={len(skip_log)}" if skip_log else ""
    return f"{desc} -> {n} records byte-identical{note}"


_SPOA_SKIPS = {"skipped": 0, "checked": 0}


def run_left_align_trial(seed: int) -> str:
    """High-volume variant for the read-conversion layer: randomized locus
    geometry (period 1-10, unit count, read mix) through compiled
    left_align_reads vs both our native and pure-Python paths."""
    import tests.ref_oracle as ro
    from test_left_align_parity import make_locus, run_ours

    rng = np.random.default_rng(seed)
    period = int(rng.integers(1, 11))
    n_units = int(rng.integers(3, 30))
    n_reads = int(rng.integers(2, 16))
    n_samples = int(rng.integers(1, 4))
    chrom, rs, re_, motif, reads = make_locus(
        rng, n_samples=n_samples, n_reads=n_reads, period=period,
        n_units=n_units)
    want = ro.left_align(chrom, "chr1", rs, re_, motif, reads)
    got = run_ours(chrom, rs, re_, motif, reads)
    assert got[0] == want[0], f"alignments differ (seed={seed})"
    assert got[1] == want[1], f"phase factors differ (seed={seed})"
    assert (got[2], got[3]) == (want[2], want[3]), f"HP counts (seed={seed})"
    os.environ["LONGTR_NO_NATIVE"] = "1"
    try:
        got_py = run_ours(chrom, rs, re_, motif, reads)
    finally:
        del os.environ["LONGTR_NO_NATIVE"]
    assert got_py == got, f"native/python divergence (seed={seed})"
    return (f"seed={seed} p={period} units={n_units} reads={n_reads} "
            f"S={n_samples} ok")


def run_trim_trial(seed: int) -> str:
    """CIGAR-surgery surface: random reads/windows through the compiled
    TrimAlignment vs our run-level transcription."""
    import tests.ref_oracle as ro
    from longtr_tpu.pipeline.alignment import FLANK_SIZE
    from test_trim_ref_parity import our_trim, random_aligned_read

    rng = np.random.default_rng(seed)
    pos = int(rng.integers(0, 2000))
    seq, quals, cigar, pos, end_pos = random_aligned_read(rng, pos)
    mid = int(rng.integers(pos - 80, end_pos + 80))
    width = int(rng.integers(0, 300))
    region_start = mid
    region_stop = mid + width
    lo = region_start - FLANK_SIZE if region_start > FLANK_SIZE else 1
    hi = region_stop + FLANK_SIZE
    want = ro.trim_alignment(seq, quals, cigar, pos, end_pos, lo, hi)
    got = our_trim(seq, quals, cigar, pos, end_pos, lo, hi)
    for key in ("pos", "end_pos", "seq", "quals", "cigar", "deleted",
                "length"):
        assert want[key] == got[key], (seed, key)
    return f"seed={seed} window=({lo},{hi}) ok"


def run_filter_trial(seed: int) -> str:
    """Read-filter surface: randomized streams (mate pairs, XA/SA alt
    mappings, multi-file/multi-RG, hard clips, unmapped) under random
    filter knobs through compiled read_and_filter_reads vs ours."""
    from test_filter_parity import mk_read, run_both

    rng = np.random.default_rng(seed)
    rs = 500
    re_ = 500 + int(rng.integers(10, 80))
    reads = []
    n = int(rng.integers(10, 70))
    for i in range(n):
        f = int(rng.integers(0, 3))
        rg = f"G{int(rng.integers(0, 2))}"
        if rng.random() < 0.5:
            kw = dict(file=f, rg=rg, paired=True, first_mate=True,
                      mate_pos=int(rng.integers(400, 700)))
            if rng.random() < 0.35:
                kw["xa"] = (f"alt{int(rng.integers(1, 3))},"
                            f"+{int(rng.integers(100, 2000))},50=,2;")
            if rng.random() < 0.3:
                kw["as_score"] = int(rng.integers(40, 60))
                kw["xs_score"] = int(rng.integers(30, 60))
            reads.append(mk_read(rng, rs, re_, f"p{i}", **kw))
            if rng.random() < 0.8:
                mkw = dict(file=f, rg=rg, paired=True, first_mate=False,
                           mate_pos=reads[-1]["pos"])
                if rng.random() < 0.3:
                    mkw["sa"] = (f"ref,{int(rng.integers(100, 5000))},"
                                 f"+,60=,60,0;")
                reads.append(mk_read(rng, rs, re_, f"p{i}", **mkw))
        else:
            kw = dict(file=f, rg=rg)
            if rng.random() < 0.1:
                kw["mapped"] = False
            reads.append(mk_read(rng, rs, re_, f"r{i}", **kw))
    reads.sort(key=lambda d: d["file"])   # ORDER_ALNS_BY_FILE
    rg_map = {f"F{f}G{g}": f"S{f}_{g}" for f in range(3) for g in range(2)}
    knobs = {}
    if rng.random() < 0.5:
        knobs = dict(require_spanning=int(rng.random() < 0.7),
                     min_mapq=float(rng.integers(0, 60)),
                     min_sum_qual=float(rng.integers(10, 40)),
                     min_flank=int(rng.integers(0, 30)),
                     require_paired=int(rng.random() < 0.3),
                     max_total_reads=int(rng.integers(5, 200)))
    want, got = run_both(reads, rs, re_, "AC", rg_map, **knobs)
    assert want == got, f"filter divergence seed={seed} knobs={knobs}"
    return f"seed={seed} n={len(reads)} knobs={bool(knobs)} ok"


def run_em_trial(seed: int) -> str:
    """EM-training surface: random read sets (period 1-6, frame mixes,
    both ploidies, shifted ref allele) must reproduce the compiled
    reference's per-iteration LL trajectory, final stutter params, and
    posterior tensor bit for bit in fidelity mode."""
    from test_em_parity import assert_em_bit_parity, gen_reads

    rng = np.random.default_rng(seed)
    ml = int(rng.integers(1, 7))
    motif = ("ACGTAC"[:ml] if ml > 1 else "A")
    fm = bool(rng.random() < 0.5) and ml > 1   # frame mix needs period > 1
    haploid = bool(rng.random() < 0.3)
    n_samples = int(rng.integers(1, 9))
    num_bps, p1s, p2s = gen_reads(n_samples, seed, ml, fm)
    n_alleles = len({b for s in num_bps for b in s} | {0})
    ref_allele = int(rng.integers(0, n_alleles)) if rng.random() < 0.3 else 0
    assert_em_bit_parity(haploid, motif, num_bps, p1s, p2s,
                         ref_allele=ref_allele)
    return (f"seed={seed} p={ml} fm={fm} hap={haploid} S={n_samples} "
            f"ref={ref_allele} ok")


def run_nw_trial(seed: int) -> str:
    """NeedlemanWunsch surface: repeat-rich sequence pairs with multi-base
    indels through compiled Align/LeftAlign vs ours — aligned strings,
    CIGAR, and the left-alignment tie-breaks must match exactly."""
    import tests.ref_oracle as ro
    from longtr_tpu.haplotype.nw import nw_align

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    # low-complexity scaffolds make ties common (where LeftAlign matters)
    style = rng.random()
    if style < 0.3:
        unit = "".join(rng.choice(bases, int(rng.integers(1, 4))))
        ref = unit * int(rng.integers(8, 40))
    elif style < 0.6:
        unit = "".join(rng.choice(bases, int(rng.integers(2, 6))))
        core = unit * int(rng.integers(4, 15))
        ref = ("".join(rng.choice(bases, int(rng.integers(5, 25)))) + core
               + "".join(rng.choice(bases, int(rng.integers(5, 25)))))
    else:
        ref = "".join(rng.choice(bases, int(rng.integers(20, 150))))
    read = list(ref)
    for _ in range(int(rng.integers(0, 4))):   # multi-base deletions
        if len(read) < 8:
            break
        p = int(rng.integers(0, len(read) - 5))
        del read[p: p + int(rng.integers(1, 6))]
    for _ in range(int(rng.integers(0, 4))):   # multi-base insertions
        p = int(rng.integers(0, len(read) + 1))
        ins = "".join(rng.choice(bases, int(rng.integers(1, 6))))
        read[p:p] = list(ins)
    for _ in range(int(rng.integers(0, 5))):   # substitutions
        if not read:
            break
        p = int(rng.integers(0, len(read)))
        read[p] = str(rng.choice(bases))
    read = "".join(read)
    if not read:
        return f"seed={seed} empty-read skip"
    # NeedlemanWunsch::LeftAlign is dead upstream (no call site; only
    # Align runs, AlignmentOps.cpp:25 / Haplotype.cpp:66) — fuzz the live
    # surface under both end-penalty modes.
    for pen in (False, True):
        ok_w, ra_w, qa_w, sc_w, cig_w = ro.nw_align(
            ref, read, use_ref_end_penalty=pen)
        ok_g, ra_g, qa_g, sc_g, cig_g = nw_align(
            ref, read, use_ref_end_penalty=pen)
        cig_gs = "".join(f"{n}{op}" for op, n in cig_g)
        assert ok_w == ok_g, (seed, pen)
        if ok_w:
            assert (ra_w, qa_w, cig_w) == (ra_g, qa_g, cig_gs), \
                (seed, pen, cig_w, cig_gs)
            assert abs(sc_w - sc_g) < 1e-3, (seed, pen, sc_w, sc_g)
    return f"seed={seed} len={len(ref)}/{len(read)} ok"


def run_denovo_trial(seed: int) -> str:
    """DenovoFinder surface: randomized trio/joint cohorts through the full
    denovofinder CLI vs the compiled TrioDenovoScanner / DenovoScanner
    (ro_denovo_scan).  Fidelity mode must be byte-identical; every third
    trial additionally replays in the default (unpruned) mode and asserts
    structural identity with last-digit-bounded values."""
    import tempfile as _tf
    from pathlib import Path

    import test_denovo_parity as dp
    from longtr_tpu.utils import mathops

    rng = np.random.default_rng(seed)
    joint = bool(rng.integers(2))
    with _tf.TemporaryDirectory() as td:
        tmp = Path(td)
        if joint:
            famlines, str_text, snp_text, use_pop = dp._joint_cohort(seed)
            skips = ()
            if rng.random() < 0.3:
                pos = [l.split("\t")[1] for l in snp_text.splitlines()
                       if l.startswith("chr")]
                step = max(1, len(pos) // int(rng.integers(10, 60)))
                skips = tuple(f"chr1:{p}" for p in pos[::step])
        else:
            famlines, str_text, use_pop = dp._trio_cohort(seed)
            snp_text, skips = None, ()
        mathops.set_ref_fidelity(True)
        try:
            ours, ref = dp.run_pair(tmp, "c", famlines, str_text, snp_text,
                                    use_pop=use_pop, skip_sites=skips)
            assert ours == ref, (seed, "fidelity divergence")
            if seed % 3 == 0:
                mathops.set_ref_fidelity(False)
                ours_d, ref_d = dp.run_pair(tmp, "cd", famlines, str_text,
                                            snp_text, use_pop=use_pop,
                                            skip_sites=skips)
                dp._assert_structurally_close(ours_d, ref_d)
        finally:
            mathops.set_ref_fidelity(False)
        n_rec = sum(1 for l in ref.splitlines() if l.startswith("chr"))
    mode = "joint" if joint else "trio"
    return f"seed={seed} {mode} records={n_rec} skips={len(skips)} ok"


def run_phasing_checker_trial(seed: int) -> str:
    """PhasingChecker surface: randomized families + phased SNP VCFs +
    unsorted BEDs through the full phasingchecker CLI vs the compiled
    check_phasing.cpp flow; byte-identical tables."""
    import tempfile as _tf
    from pathlib import Path

    import test_phasing_checker_parity as pc

    with _tf.TemporaryDirectory() as td:
        famlines, snp_text, bed_text = pc._cohort(seed)
        ours, ref = pc.run_pair(Path(td), "c", famlines, snp_text, bed_text)
        assert ours == ref, (seed, "phasing checker divergence")
        n_rows = len(ref.splitlines()) - 1
    return f"seed={seed} rows={n_rows} ok"


def run_pedigree_trial(seed: int) -> str:
    """FAM-pedigree surface: randomized pedigrees (nuclear / 3-gen /
    half-sib / corrupted) through compiled extract_pedigree_nuclear_families
    vs ours — family lists in order, or matching error classes."""
    from test_pedigree_parity import run_pedigree_trial as trial

    # The reference prints node dumps to C++ std::cerr on its "Logical
    # error" path; redirect fd 2 around the call for output hygiene
    # (Python-level redirect_stderr can't see the C++ stream).
    saved = os.dup(2)
    devnull = os.open(os.devnull, os.O_WRONLY)
    try:
        os.dup2(devnull, 2)
        return trial(seed)
    finally:
        os.dup2(saved, 2)
        os.close(saved)
        os.close(devnull)


def main():
    import tests.ref_oracle as ro
    if ro.get_lib() is None:
        print("reference oracle unavailable; cannot run")
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    surface = "records"
    if "--left-align" in sys.argv:
        surface = "left_align"
    elif "--trim" in sys.argv:
        surface = "trim"
    elif "--filters" in sys.argv:
        surface = "filters"
    elif "--em" in sys.argv:
        surface = "em"
    elif "--nw" in sys.argv:
        surface = "nw"
    elif "--pedigree" in sys.argv:
        surface = "pedigree"
    elif "--denovo" in sys.argv:
        surface = "denovo"
    elif "--phasing" in sys.argv:
        surface = "phasing"
    if surface in ("left_align", "trim") and ro.get_trim_lib() is None:
        print("trim oracle unavailable; cannot run")
        return 2
    n_trials = int(args[0]) if args else 50
    start = int(args[1]) if len(args) > 1 else 1000
    trial_fn = {"records": run_trial, "left_align": run_left_align_trial,
                "trim": run_trim_trial, "filters": run_filter_trial,
                "em": run_em_trial, "nw": run_nw_trial,
                "pedigree": run_pedigree_trial,
                "denovo": run_denovo_trial,
                "phasing": run_phasing_checker_trial}[surface]
    quiet_every = {"records": 1, "left_align": 200, "trim": 1000,
                   "filters": 500, "em": 100, "nw": 500,
                   "pedigree": 1000, "denovo": 50,
                   "phasing": 100}[surface]
    for t in range(n_trials):
        seed = start + t
        try:
            msg = trial_fn(seed)
        except AssertionError as e:
            print(f"DIVERGENCE at seed={seed}: {e}", flush=True)
            return 1
        if (t + 1) % quiet_every == 0 or t + 1 == n_trials:
            print(f"[{t + 1}/{n_trials}] {msg}", flush=True)
    if surface == "records":
        tot = _SPOA_SKIPS["checked"] + _SPOA_SKIPS["skipped"]
        pct = 100.0 * _SPOA_SKIPS["skipped"] / tot if tot else 0.0
        print(f"rescue-path spoa-sampling skips: {_SPOA_SKIPS['skipped']} "
              f"loci ({pct:.1f}% of {tot} replay-eligible)")
    print("campaign clean")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())

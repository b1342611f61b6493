"""Parity tests against ACTUAL compiled reference code (tests/ref_oracle).

Round-1 verification relied on hand-transcribed oracles (a shared-misreading
failure mode).  Here the htslib-free reference sources are compiled directly
(g++, no network) and our implementations are asserted against them:
mathops LSE, Mineiro fastapprox bit patterns, stutter PMF, Z-arrays,
de Bruijn kmer/path enumeration, haplotype Gray-code order, and the full
HapAligner mode-A and mode-B per-read/per-haplotype log-likelihoods.
"""

import math

import numpy as np
import pytest

import tests.ref_oracle as ro

pytestmark = pytest.mark.skipif(ro.get_lib() is None,
                                reason="reference oracle unavailable")

RNG = np.random.default_rng(20260817)
BASES = np.array(list("ACGT"))


def rand_seq(n):
    return "".join(RNG.choice(BASES, size=n))


# ---------------------------------------------------------------------------
# mathops
# ---------------------------------------------------------------------------

def test_log_sum_exp_matches_reference():
    from longtr_tpu.utils import mathops
    for _ in range(50):
        n = int(RNG.integers(1, 40))
        vals = RNG.uniform(-80, 0, n)
        assert mathops.log_sum_exp(vals) == pytest.approx(
            ro.log_sum_exp(vals), abs=1e-12)
    lib = ro.get_lib()
    for _ in range(20):
        a, b, c = RNG.uniform(-50, 0, 3)
        assert mathops.log_sum_exp([a, b]) == pytest.approx(
            lib.ro_log_sum_exp2(a, b), abs=1e-12)
        assert mathops.log_sum_exp([a, b, c]) == pytest.approx(
            lib.ro_log_sum_exp3(a, b, c), abs=1e-12)


def test_int_log_matches_reference():
    from longtr_tpu.utils.mathops import int_log
    for v in [1, 2, 3, 10, 999, 12345, 999999]:
        assert int_log(v) == ro.get_lib().ro_int_log(v)
    assert int_log(0) == ro.get_lib().ro_int_log(0) == -1000.0


def test_fastapprox_bit_identical_to_reference():
    """Mineiro port: bit-identical over wide random + structured grids."""
    from longtr_tpu.utils import fastapprox as fa
    xs_log = np.concatenate([
        RNG.uniform(1e-6, 1e6, 50000).astype(np.float32),
        np.float32(10) ** RNG.uniform(-35, 35, 50000).astype(np.float32),
        np.float32([1.0, 2.0, 0.5, 1e-30, 1e30, np.pi])])
    xs_exp = np.concatenate([
        RNG.uniform(-700, 85, 50000).astype(np.float32),
        np.float32([0.0, -1.0, 1.0, -126.0, -127.0, -1000.0, 80.0])])
    for name, ours, dom in [("fastlog", fa.fastlog, xs_log),
                            ("fasterlog", fa.fasterlog, xs_log),
                            ("fastexp", fa.fastexp, xs_exp),
                            ("fasterexp", fa.fasterexp, xs_exp)]:
        ref = ro.fast_fn_arr(name, dom)
        got = np.asarray(ours(dom), np.float32)
        assert np.array_equal(ref.view(np.uint32), got.view(np.uint32)), name


def test_fast_log_sum_exp_fidelity_bit_equal():
    """With the fidelity switch on, our fast LSE == compiled reference,
    bit for bit, including term-dropping boundaries."""
    from longtr_tpu.utils import mathops
    lib = ro.get_lib()
    mathops.set_ref_fidelity(True)
    try:
        for _ in range(200):
            n = int(RNG.integers(2, 30))
            vals = RNG.uniform(-40, 0, n)
            assert mathops.fast_log_sum_exp(vals) == ro.fast_log_sum_exp(vals)
            a, b = RNG.uniform(-40, 0, 2)
            assert mathops.fast_log_sum_exp2(a, b) == \
                lib.ro_fast_log_sum_exp2(a, b)
        # term-drop boundary: difference right at log(0.001)
        a = -5.0
        for eps in (-1e-9, 0.0, 1e-9):
            b = a + math.log(0.001) + eps
            assert mathops.fast_log_sum_exp2(a, b) == \
                lib.ro_fast_log_sum_exp2(a, b)
    finally:
        mathops.set_ref_fidelity(False)


# ---------------------------------------------------------------------------
# stutter PMF
# ---------------------------------------------------------------------------

def test_stutter_pmf_matches_reference():
    from longtr_tpu.models.stutter import StutterModel
    param_sets = [
        (0.95, 0.05, 0.05, 0.95, 0.01, 0.01),   # CLI default
        (0.9, 0.1, 0.1, 0.8, 0.01, 0.01),       # EM init
        (0.75, 0.02, 0.2, 0.6, 0.05, 0.02),
    ]
    for in_geom, in_up, in_down, out_geom, out_up, out_down in param_sets:
        for period in (1, 2, 3, 4, 6):
            ours = StutterModel(in_geom, in_up, in_down, out_geom, out_up,
                                out_down, "N" * period)
            for sample_bps in (0, 7, 20, 45):
                for read_bps in range(sample_bps - 25, sample_bps + 26):
                    want = ro.stutter_log_pmf(
                        (in_geom, in_up, in_down, out_geom, out_up, out_down),
                        period, sample_bps, read_bps)
                    got = ours.log_stutter_pmf(sample_bps, read_bps)
                    assert got == pytest.approx(want, abs=1e-12), (
                        period, sample_bps, read_bps)


# ---------------------------------------------------------------------------
# Z-algorithm
# ---------------------------------------------------------------------------

def test_zalgorithm_matches_reference():
    from longtr_tpu.pipeline.alignment_filters import (prefix_match_counts,
                                                       suffix_match_counts)
    cases = [(rand_seq(int(RNG.integers(1, 40))),
              rand_seq(int(RNG.integers(1, 60)))) for _ in range(40)]
    cases += [("ACGT", "ACGTACGT"), ("AAAA", "AAAAAAA"), ("A", "A")]
    for s1, s2 in cases:
        assert list(prefix_match_counts(s1, s2)) == ro.z_prefix(s1, s2)
        assert list(suffix_match_counts(s1, s2)) == ro.z_suffix(s1, s2)


# ---------------------------------------------------------------------------
# de Bruijn graph
# ---------------------------------------------------------------------------

def test_debruijn_kmer_length_matches_reference():
    from longtr_tpu.haplotype.debruijn import calc_kmer_length
    for _ in range(30):
        seq = rand_seq(int(RNG.integers(20, 120)))
        assert calc_kmer_length(seq, 10, 15) == ro.db_kmer_length(seq, 10, 15)
    # repetitive flank: force failure parity
    rep = "ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT" * 2
    assert calc_kmer_length(rep, 10, 15) == ro.db_kmer_length(rep, 10, 15)


def test_debruijn_paths_match_reference():
    from longtr_tpu.haplotype.debruijn import DebruijnGraph
    for trial in range(15):
        ref = rand_seq(int(RNG.integers(30, 60)))
        reads = []
        for _ in range(int(RNG.integers(3, 10))):
            # reads: ref with occasional substitutions
            r = list(ref)
            for _ in range(int(RNG.integers(0, 3))):
                i = int(RNG.integers(0, len(r)))
                r[i] = str(RNG.choice(BASES))
            reads.append("".join(r))
        k = ro.db_kmer_length(ref, 10, 15)
        if k is None:
            continue
        want = ro.db_paths(k, ref, reads, 0.02, 2, 2, 10)
        g = DebruijnGraph(k, ref)
        for r in reads:
            g.add_string(r)
        g.prune_edges(0.02, 2)
        if not (g.is_source_ok() and g.is_sink_ok()):
            got = []
        else:
            got = g.enumerate_paths(2, 10)
        assert sorted(got) == sorted(want), trial


# ---------------------------------------------------------------------------
# Haplotype enumeration (Gray-code order)
# ---------------------------------------------------------------------------

def _our_haplotype(lflank, rep, alts, period, rflank, start=1000):
    from longtr_tpu.haplotype.blocks import HapBlock, Haplotype, RepeatBlock
    from longtr_tpu.models.stutter import StutterModel
    model = StutterModel(0.9, 0.05, 0.05, 0.9, 0.01, 0.01, "N" * period)
    rs = start + len(lflank)
    re_ = rs + len(rep)
    blocks = [HapBlock(start, rs, lflank)]
    rb = RepeatBlock(rs, re_, rep, period, model)
    for a in alts:
        rb.add_alternate(a)
    blocks.append(rb)
    blocks.append(HapBlock(re_, re_ + len(rflank), rflank))
    return Haplotype(blocks)


def test_haplotype_enumeration_matches_reference():
    lf, rf = rand_seq(35), rand_seq(35)
    rep = "AC" * 8
    alts = ["AC" * 6, "AC" * 10, "AC" * 7 + "A"]
    want = ro.hap_enumeration(lf, rep, alts, 2, rf)
    hap = _our_haplotype(lf, rep, alts, 2, rf, start=100)
    got = hap.all_seqs()
    assert got == want


# ---------------------------------------------------------------------------
# HapAligner mode A: per-(read, haplotype) LLs vs actual reference DP
# ---------------------------------------------------------------------------

STUTTER = (0.9, 0.05, 0.05, 0.9, 0.01, 0.01)


def _mode_a_fixture(period=2, n_units=8):
    start = 1000
    lf, rf = rand_seq(35), rand_seq(35)
    motif = rand_seq(period)
    rep = motif * n_units
    alts = [motif * (n_units - 2), motif * (n_units + 2)]
    rs = start + 35
    re_ = rs + len(rep)

    from longtr_tpu.pipeline.alignment import Alignment

    reads = []

    def add(seq, cigar, pos):
        span = sum(n for op, n in cigar if op in "M=DX")
        reads.append(Alignment(pos, pos + span - 1, False, False,
                               f"r{len(reads)}", "I" * len(seq), seq,
                               cigar=[(op, n) for op, n in cigar]))

    # exact ref span
    add(lf + rep + rf, [("=", 35 + len(rep) + 35)], start)
    # allele-1 read (2-unit deletion)
    add(lf + alts[0] + rf,
        [("=", 35 + len(alts[0])), ("D", 2 * period), ("=", 35)], start)
    # allele-2 read (2-unit insertion)
    add(lf + alts[1] + rf,
        [("=", 35 + len(rep)), ("I", 2 * period), ("=", 35)], start)
    # ref read with two mismatches in the flanks
    seq = list(lf + rep + rf)
    seq[10] = "A" if seq[10] != "A" else "C"
    seq[-8] = "G" if seq[-8] != "G" else "T"
    L = len(seq)
    add("".join(seq), [("=", 10), ("X", 1), ("=", L - 19), ("X", 1),
                       ("=", 7)], start)
    # partially-spanning read (starts inside the left flank)
    add((lf + rep + rf)[20:], [("=", 35 + len(rep) + 15)], start + 20)
    return lf, rep, alts, rs, rf, start, reads


def test_mode_a_hapaligner_matches_reference():
    """Our mode-A scoring (trim + f32 DP) vs the compiled reference
    HapAligner::process_read, per read per haplotype."""
    from longtr_tpu.pipeline.seq_genotyper import HapAlignerBatch
    from longtr_tpu.ops.pairhmm import pairhmm_score_oracle
    from longtr_tpu.pipeline.seq_genotyper import trim_read_for_hapalign

    for period, n_units in [(2, 8), (3, 6), (1, 20), (4, 5)]:
        lf, rep, alts, rs, rf, start, reads = _mode_a_fixture(period, n_units)
        hap = _our_haplotype(lf, rep, alts, period, rf, start=start)
        aligner = HapAlignerBatch(hap, indel_flank_len=5)
        ours = aligner.score_pools(reads)                 # (reads, haps) f32
        for ri, aln in enumerate(reads):
            want, seed = ro.hap_aligner_scores(
                lf, start, rep, alts, rs, period, rf, STUTTER,
                aln.sequence, aln.base_qualities, aln.start, aln.stop,
                aln.cigar, indel_flank_len=5, switch_old_align_len=0)
            # f64 oracle vs reference: same double DP, float constants
            trimmed = trim_read_for_hapalign(aln, rs, rs + len(rep), 5)
            for hi, hseq in enumerate(hap.all_seqs()):
                clip = 30  # REF_FLANK_LEN - INDEL_FLANK_LEN
                h_trim = hseq[clip: len(hseq) - clip]
                got64 = pairhmm_score_oracle(h_trim, trimmed,
                                             full_hap_len=len(hseq))
                assert got64 == pytest.approx(want[hi], abs=1e-9), (
                    period, ri, hi)
            # f32 production path vs reference: small accumulation drift
            np.testing.assert_allclose(ours[ri], want, atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# HapAligner mode B: seed-split stutter HMM vs actual reference
# ---------------------------------------------------------------------------

def _quals(n):
    return "".join(chr(int(q)) for q in RNG.integers(ord("5"), ord("J"), n))


def test_mode_b_hapaligner_matches_reference():
    """Mode-B per-read per-haplotype LLs vs the compiled reference,
    BIT-IDENTICAL in reference-fidelity math mode: the stutter primitive,
    the flank-row closed-form insert chain (prefix-blc cummax), the seed
    marginalization and the Mineiro fast-LSE all reproduce the reference's
    exact float operations."""
    from longtr_tpu.pipeline.alignment import Alignment
    from longtr_tpu.pipeline.mode_b import ModeBAligner, calc_seed_base
    from longtr_tpu.utils import mathops

    rng = np.random.default_rng(555)

    def rseq(n):
        return "".join(rng.choice(BASES, size=n))

    def rquals(n):
        return "".join(chr(int(q)) for q in rng.integers(ord("5"), ord("J"), n))

    n_compared = 0
    mathops.set_ref_fidelity(True)
    try:
        for trial in range(12):
            start = 1000
            lf, rf = rseq(35), rseq(35)
            n_units = int(rng.integers(8, 25))
            rep = "A" * n_units
            alts = ["A" * (n_units - d) for d in (1, 2) if n_units - d > 3]
            alts += ["A" * (n_units + 2)]
            rs = start + 35
            hap = _our_haplotype(lf, rep, alts, 1, rf, start=start)

            # spanning reads: one per allele plus a mismatched one
            reads = []
            for allele in [rep] + alts:
                seq = lf + allele + rf
                d = len(allele) - len(rep)
                if d == 0:
                    cigar = [("=", len(seq))]
                elif d < 0:
                    cigar = [("=", 35 + len(allele)), ("D", -d), ("=", 35)]
                else:
                    cigar = [("=", 35 + len(rep)), ("I", d), ("=", 35)]
                span = sum(n for op, n in cigar if op in "=XMD")
                reads.append(Alignment(start, start + span - 1, False, False,
                                       f"m{len(reads)}", rquals(len(seq)),
                                       seq, cigar=cigar))
            seqm = list(lf + rep + rf)
            seqm[5] = "C"
            cigar = [("=", 5), ("X", 1), ("=", len(seqm) - 6)]
            reads.append(Alignment(start, start + len(seqm) - 1, False,
                                   False, "mx", rquals(len(seqm)),
                                   "".join(seqm), cigar=cigar))

            aligner = ModeBAligner(hap)
            hap_start = hap.blocks[0].start
            hap_end = hap.blocks[-1].end
            for aln in reads:
                want, ref_seed = ro.hap_aligner_scores(
                    lf, start, rep, alts, rs, 1, rf, STUTTER,
                    aln.sequence, aln.base_qualities, aln.start, aln.stop,
                    aln.cigar, indel_flank_len=5, switch_old_align_len=25)
                our_seed = calc_seed_base(
                    aln, [rs], [rs + len(rep)], hap_start, hap_end)
                assert our_seed == ref_seed, (trial, aln.name)
                if ref_seed == -1:
                    continue
                got = aligner.score_read(aln, our_seed)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{trial} {aln.name}")
                n_compared += len(got)
    finally:
        mathops.set_ref_fidelity(False)
    assert n_compared >= 200, n_compared


def test_e2e_pipeline_runs_in_fidelity_mode(tmp_path):
    """The full CLI pipeline produces a well-formed VCF with the Mineiro
    fidelity math switched on, and calls stay concordant with exact math
    (the approximations perturb LLs ~1e-5, far under call resolution)."""
    import gzip
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import standard_fixture

    from longtr_tpu.cli import main as cli_main
    from longtr_tpu.utils import mathops

    fx = standard_fixture(str(tmp_path))
    base = ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--use-unpaired", "--quiet"]
    out1 = str(tmp_path / "exact.vcf.gz")
    assert cli_main(base + ["--tr-vcf", out1]) == 0
    mathops.set_ref_fidelity(True)
    try:
        out2 = str(tmp_path / "fidelity.vcf.gz")
        assert cli_main(base + ["--tr-vcf", out2]) == 0
    finally:
        mathops.set_ref_fidelity(False)

    def records(p):
        return [ln.split("\t") for ln in
                gzip.decompress(open(p, "rb").read()).decode().splitlines()
                if not ln.startswith("#")]

    r1, r2 = records(out1), records(out2)
    assert len(r1) == len(r2) > 0
    for a, b in zip(r1, r2):
        assert a[:5] == b[:5]          # same loci and alleles
        # same GT calls per sample
        gts1 = [f.split(":")[0] for f in a[9:]]
        gts2 = [f.split(":")[0] for f in b[9:]]
        assert gts1 == gts2


def test_posterior_kernel_matches_reference():
    """Genotyper::calc_log_sample_posteriors vs our production math:
    bit-identical in fidelity mode (raw log(exp+exp) T), 1e-12 otherwise.
    Includes sub--600 LLs to exercise the in-place clamp quirk."""
    from longtr_tpu.ops.posterior import genotype_log_priors, posteriors_oracle
    from longtr_tpu.utils import mathops
    from longtr_tpu.utils.mathops import LOG_ONE_HALF

    for haploid in (False, True):
        for trial in range(5):
            S = int(RNG.integers(2, 6))
            A = int(RNG.integers(2, 7))
            counts = [int(RNG.integers(1, 12)) for _ in range(S)]
            R = sum(counts)
            labels = np.repeat(np.arange(S), counts)
            LL = RNG.uniform(-650, 0, (R, A))
            p1 = RNG.uniform(-3, 0, R)
            p2 = RNG.uniform(-3, 0, R)
            P, tot, total = ro.posteriors(LL, p1, p2, counts, haploid)
            # f64 oracle: bit-exact
            P2, tot2, total2 = posteriors_oracle(LL, p1, p2, labels, S,
                                                 haploid)
            np.testing.assert_array_equal(P2, P)
            np.testing.assert_array_equal(tot2, tot)
            # production expression in fidelity mode: bit-exact
            mathops.set_ref_fidelity(True)
            try:
                prior = genotype_log_priors(A, haploid)
                LLc = np.clip(LL, -600.0, None)
                a = LLc + p1[:, None] + LOG_ONE_HALF
                b = LLc + p2[:, None] + LOG_ONE_HALF
                T = np.log(np.exp(a[:, :, None]) + np.exp(b[:, None, :]))
                Pp = np.tile(prior[None], (S, 1, 1))
                np.add.at(Pp, labels, T)
                flat = Pp.reshape(S, -1)
                m = flat.max(axis=1)
                totals = m + np.log(np.exp(flat - m[:, None]).sum(axis=1))
                Pp -= totals[:, None, None]
                np.testing.assert_array_equal(Pp, P)
                np.testing.assert_array_equal(totals, tot)
            finally:
                mathops.set_ref_fidelity(False)


def test_genotype_extraction_matches_reference():
    """extract_genotypes_and_likelihoods (MAP, GL, GLDIFF, phased/unphased
    posteriors) bit-identical to the compiled reference in fidelity mode."""
    from longtr_tpu.models.genotyper import extract_genotypes_and_likelihoods
    from longtr_tpu.utils import mathops

    mathops.set_ref_fidelity(True)
    try:
        for trial in range(8):
            S = int(RNG.integers(2, 6))
            V = int(RNG.integers(2, 5))
            A = V + int(RNG.integers(0, 4))       # some haps share a variant
            h2a = np.concatenate([np.arange(V),
                                  RNG.integers(0, V, A - V)]).astype(np.int32)
            counts = [int(RNG.integers(1, 10)) for _ in range(S)]
            LL = RNG.uniform(-40, 0, (sum(counts), A))
            p1 = RNG.uniform(-3, 0, sum(counts))
            p2 = RNG.uniform(-3, 0, sum(counts))
            want = ro.extract_gls(LL, p1, p2, counts, False, V, h2a)
            P, tot, _ = ro.posteriors(LL, p1, p2, counts, False)
            got = extract_genotypes_and_likelihoods(
                P, tot, h2a, V, False, calc_gls=True, want_pls=True)
            assert [tuple(x) for x in want["best_haps"]] == got.best_haplotypes
            assert [tuple(x) for x in want["best_gts"]] == got.best_gts
            np.testing.assert_array_equal(np.stack(got.gls), want["gls"])
            np.testing.assert_array_equal(np.asarray(got.gl_diffs),
                                          want["gl_diffs"])
            np.testing.assert_array_equal(got.log_phased_posteriors,
                                          want["log_phased"])
            np.testing.assert_array_equal(got.log_unphased_posteriors,
                                          want["log_unphased"])
    finally:
        mathops.set_ref_fidelity(False)


def test_nw_matches_reference():
    """NeedlemanWunsch::Align parity: aligned strings, score, CIGAR."""
    from longtr_tpu.haplotype.nw import nw_align

    for _ in range(40):
        ref = rand_seq(int(RNG.integers(10, 90)))
        read = "".join(c for c in ref if RNG.random() > 0.04)
        read = "".join(c if RNG.random() > 0.03 else str(RNG.choice(BASES))
                       for c in read)
        if not read:
            continue
        for pen in (False, True):
            ok_w, ra_w, qa_w, sc_w, cig_w = ro.nw_align(
                ref, read, use_ref_end_penalty=pen)
            ok_g, ra_g, qa_g, sc_g, cig_g = nw_align(
                ref, read, use_ref_end_penalty=pen)
            cig_gs = "".join(f"{n}{op}" for op, n in cig_g)
            assert ok_w == ok_g
            if ok_w:
                assert (ra_w, qa_w, cig_w) == (ra_g, qa_g, cig_gs)
                assert sc_w == pytest.approx(sc_g, abs=1e-4)


def test_haplotype_generator_blocks_match_reference():
    """Candidate-allele extraction + trim + fuse vs the compiled reference
    HaplotypeGenerator (exact-support path; the POA-rescue path is
    nondeterministic upstream and spoa-stubbed in the oracle)."""
    from longtr_tpu.haplotype.generator import HaplotypeGenerator
    from longtr_tpu.models.stutter import StutterModel
    from longtr_tpu.pipeline.alignment import Alignment
    from longtr_tpu.regions import Region

    for trial in range(8):
        period = int(RNG.integers(1, 5))
        motif = rand_seq(period)
        n_units = int(RNG.integers(6, 14))
        chrom = rand_seq(300)
        rs = 120
        rep = motif * n_units
        re_ = rs + len(rep)
        chrom = chrom[:rs] + rep + chrom[rs:]
        # two alleles: ref and a +/-1-unit variant, clean support
        alt_units = n_units + (1 if RNG.random() < 0.5 else -1)
        alt = motif * alt_units
        reads = [[], []]
        for s in range(2):
            for allele in (rep, alt):
                seq = chrom[rs - 60: rs] + allele + chrom[re_: re_ + 60]
                if allele == rep:
                    cig = [("=", len(seq))]
                elif len(allele) < len(rep):
                    cig = [("=", 60 + len(alt)), ("D", len(rep) - len(alt)),
                           ("=", 60)]
                else:
                    cig = [("=", 60 + len(rep)), ("I", len(alt) - len(rep)),
                           ("=", 60)]
                span = sum(n for op, n in cig if op in "=XMD")
                # alignment string: bases with '-' runs for deletions
                aln_str = ""
                qi = 0
                for op, num in cig:
                    if op == "D":
                        aln_str += "-" * num
                    else:
                        aln_str += seq[qi: qi + num]
                        qi += num
                for _ in range(4):
                    reads[s].append(Alignment(
                        rs - 60, rs - 60 + span - 1, False, False,
                        f"r{len(reads[s])}", "I" * len(seq), seq,
                        alignment=aln_str, cigar=cig, use_for_haps=[True]))

        want = ro.hapgen_blocks(
            chrom, rs, re_, motif,
            [[(a.sequence, a.alignment, a.start, a.stop,
               "".join(f"{n}{op}" for op, n in a.cigar)) for a in sample]
             for sample in reads])
        assert not isinstance(want, str), want

        region = Region("chr1", rs, re_, motif, name="T")
        gen = HaplotypeGenerator(
            min(a.start for s in reads for a in s),
            max(a.stop for s in reads for a in s), 5)
        model = StutterModel(0.9, 0.05, 0.05, 0.9, 0.01, 0.01, motif)
        assert gen.add_haplotype_block(region, chrom, reads, [], model), \
            gen.failure_msg
        assert gen.fuse_haplotype_blocks(chrom)
        hap = gen.get_haplotype()
        got = [(b.start, b.end, list(b.seqs), list(b.inexact))
               for b in hap.blocks]
        assert got == [tuple(w) if isinstance(w, tuple) else w
                       for w in [(a, b, c, d) for a, b, c, d in want]], trial

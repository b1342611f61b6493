"""Run configuration — all tunables with the reference CLI's defaults.

Reference: public members of BamProcessor (bam_processor.h:79-104),
GenotyperBamProcessor (genotyper_bam_processor.h:96-127) and the CLI defaults
(hipstr_main.cpp:140, 362-370).  Notable reference behaviours kept:

* a default stutter model is ALWAYS installed (def_stutter_model=1,
  hipstr_main.cpp:140) so EM learning only runs when explicitly disabled,
* ``--skip-assembly`` INVERTS skip_assembly to False, i.e. the flag *enables*
  assembly (hipstr_main.cpp:193, 368-370),
* ``--min-mean-qual`` compares the mean phred score despite the
  MIN_SUM_QUAL_LOG_PROB name (base_quality.h:77-84).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Config:
    # BamProcessor tunables (bam_processor.h:79-104)
    max_mate_dist: int = 1000
    min_bp_before_indel: int = 7
    min_flank: int = 5
    min_read_end_match: int = 10
    maximal_end_match_window: int = 15
    require_spanning: bool = True
    require_paired_reads: bool = False
    remove_pcr_dups: bool = False
    max_str_length: int = 1000
    min_sum_qual_log_prob: float = 30.0   # mean phred threshold (see note)
    min_mapq: float = 20.0
    max_total_reads: int = 1_000_000
    base_qual_trim: str = "5"

    # GenotyperBamProcessor tunables (genotyper_bam_processor.h:96-127)
    max_em_iter: int = 100
    abs_ll_converge: float = 0.01
    frac_ll_converge: float = 0.001
    min_total_reads: int = 10
    max_total_haplotypes: int = 1000
    max_flank_haplotypes: int = 4
    indel_flank_len: int = 5
    switch_old_align_len: int = 0
    min_flank_freq: float = 0.01

    # CLI-level (hipstr_main.cpp:140, 362-370)
    use_default_stutter_model: bool = True
    skip_assembly: bool = True            # --skip-assembly flag sets False
    phased_bam: bool = False
    haploid_chroms: set = field(default_factory=set)
    alignment_params: list = None          # 7 negative log-probs or None
    sample_set: set = field(default_factory=set)

    # Output flags (genotyper.cpp:339-346)
    output_gls: bool = False
    output_pls: bool = False
    output_phased_gls: bool = False
    output_allreads: bool = True
    output_mallreads: bool = True
    output_filters: bool = False
    output_haplotype_data: bool = False
    max_flank_indel_frac: float = 0.15

    # Stutter model I/O
    stutter_in: str = ""
    stutter_out: str = ""

    # Dispatch scheduling: number of loci whose pair-HMM work is fused
    # into one device call (the reference is strictly per-locus).  Large
    # windows amortize dispatch latency; host memory per window is tiny.
    base_qual_trim: str = "5"   # --read-qual-trim; > ' ' gates the
                                # hard-clip filter (bam_processor.cpp:226-240)
    viz_left_alns: bool = False
    locus_batch: int = 256

    # Phasing constants (snp_bam_processor.h:16-18, 54, 103)
    from_hap_ll: float = -0.000001
    other_hap_ll: float = -1000.0
    skip_padding: int = 15

    def output_flags(self):
        from longtr_tpu.pipeline.vcf_record import OutputFlags
        f = OutputFlags()
        f.gls = self.output_gls
        f.pls = self.output_pls
        f.phased_gls = self.output_phased_gls
        f.allreads = self.output_allreads
        f.mallreads = self.output_mallreads
        f.filters = self.output_filters
        f.haplotype_data = self.output_haplotype_data
        f.max_flank_indel_frac = self.max_flank_indel_frac
        return f

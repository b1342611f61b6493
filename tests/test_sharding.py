"""Shard/merge workflow: N-shard runs produce identical calls to 1 run."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from synth import standard_fixture, vcf_body  # noqa: E402

from longtr_tpu.cli import main as cli_main  # noqa: E402
from longtr_tpu.parallel.multihost import (merge_sorted_vcfs,  # noqa: E402
                                           shard_regions)


def test_shard_regions_partition():
    regions = list(range(10))
    shards = [shard_regions(regions, 3, i) for i in range(3)]
    assert sorted(x for s in shards for x in s) == regions
    assert shards[0] == [0, 3, 6, 9]
    # block mode: contiguous, balanced, covering
    blocks = [shard_regions(regions, 3, i, "block") for i in range(3)]
    assert [x for b in blocks for x in b] == regions
    assert blocks[0] == [0, 1, 2]
    assert {len(b) for b in blocks} <= {3, 4}


def test_sharded_runs_merge_to_single_run(tmp_path):
    fx = standard_fixture(str(tmp_path))
    base = ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--min-reads", "5", "--quiet"]
    whole = str(tmp_path / "whole.vcf.gz")
    assert cli_main(base + ["--tr-vcf", whole]) == 0
    for mode in ("interleave", "block"):
        shard_paths = []
        for i in range(2):
            p = str(tmp_path / f"{mode}{i}.vcf.gz")
            assert cli_main(base + ["--tr-vcf", p, "--shard", f"{i}/2",
                                    "--shard-mode", mode]) == 0
            shard_paths.append(p)
        merged = str(tmp_path / f"merged_{mode}.vcf.gz")
        merge_sorted_vcfs(shard_paths, merged)
        assert vcf_body(merged) == vcf_body(whole), mode


def test_workers_mode_matches_single_run(tmp_path, monkeypatch):
    """`--workers 2` (in-process multi-worker fan-out + merge) reproduces
    the single-process VCF body and leaves no shard litter behind."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # inherited by subprocesses
    fx = standard_fixture(str(tmp_path))
    base = ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--min-reads", "5", "--quiet"]
    whole = str(tmp_path / "whole.vcf.gz")
    metrics1 = str(tmp_path / "metrics1.json")
    pass1 = str(tmp_path / "pass1.bam")
    assert cli_main(base + ["--tr-vcf", whole, "--pass-bam", pass1,
                            "--metrics-out", metrics1]) == 0
    multi = str(tmp_path / "multi.vcf.gz")
    metrics = str(tmp_path / "metrics.json")
    passn = str(tmp_path / "passn.bam")
    assert cli_main(base + ["--tr-vcf", multi, "--workers", "2",
                            # `=` form: the worker fan-out must normalize
                            # it, else every worker writes the SAME path
                            f"--pass-bam={passn}",
                            "--metrics-out", metrics]) == 0
    assert vcf_body(multi) == vcf_body(whole)
    assert os.path.exists(multi + ".tbi")
    assert not [p for p in os.listdir(tmp_path) if ".shard" in p]

    # per-shard --pass-bam outputs merge into one sorted BAM holding the
    # same records as the single run (previously every worker wrote the
    # SAME path concurrently -> corrupt output)
    def bam_keys(path):
        from longtr_tpu.io.bam import BamReader
        r = BamReader(path)
        out = []
        while (rec := r.get_next_alignment()) is not None:
            out.append((rec.name, rec.ref_id, rec.pos))
        return out

    got, want = bam_keys(passn), bam_keys(pass1)
    assert sorted(got) == sorted(want) and len(got) > 0
    assert got == sorted(got, key=lambda k: (k[1], k[2]))  # coord-sorted
    import json
    with open(metrics) as fh:
        m = json.load(fh)
    with open(metrics1) as fh:
        m1 = json.load(fh)
    # merged worker counters sum to the single-run counters
    for key in ("loci_processed", "num_genotype_success"):
        assert m[key] == m1[key]


def test_pairhmm_batch_sharded_matches_single_device():
    """Mesh-sharded scoring (the production multi-chip dispatch) is
    element-wise identical to the single-device batch."""
    import numpy as np

    from longtr_tpu.ops.pairhmm import (AlignmentParams, encode_seq,
                                        pairhmm_batch)
    from longtr_tpu.parallel.mesh import make_mesh, pairhmm_batch_sharded

    rng = np.random.default_rng(9)
    bases = np.array(list("ACGT"))
    B, N, M = 83, 96, 90   # deliberately not a multiple of the device grid
    haps = ["".join(rng.choice(bases, size=int(rng.integers(40, N))))
            for _ in range(B)]
    reads = ["".join(ch for ch in h if rng.random() > 0.01)[:M] for h in haps]
    hap_codes = np.stack([encode_seq(h, N) for h in haps])
    read_codes = np.stack([encode_seq(r, M) for r in reads])
    hl = np.array([len(h) for h in haps], np.int32)
    rl = np.array([len(r) for r in reads], np.int32)
    fl = hl + 60
    params = AlignmentParams()
    single = np.asarray(pairhmm_batch(hap_codes, hl, read_codes, rl, fl,
                                      params))
    mesh = make_mesh(8)
    sharded = pairhmm_batch_sharded(hap_codes, hl, read_codes, rl, fl,
                                    params, mesh=mesh)
    assert sharded.shape == single.shape
    assert np.array_equal(sharded, single)


def test_e2e_pipeline_through_mesh(tmp_path, monkeypatch):
    """LONGTR_FORCE_MESH routes the whole pipeline's scoring through the
    8-device mesh; the VCF must match the single-device run exactly."""
    import gzip
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import standard_fixture

    from longtr_tpu.cli import main as cli_main

    fx = standard_fixture(str(tmp_path))
    base = ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--use-unpaired", "--quiet"]
    out1 = str(tmp_path / "single.vcf.gz")
    assert cli_main(base + ["--tr-vcf", out1]) == 0
    out2 = str(tmp_path / "meshed.vcf.gz")
    monkeypatch.setenv("LONGTR_FORCE_MESH", "1")
    assert cli_main(base + ["--tr-vcf", out2]) == 0

    def body(p):
        return [ln for ln in
                gzip.decompress(open(p, "rb").read()).decode().splitlines()
                if not ln.startswith("##command")]

    assert body(out1) == body(out2)


def test_parallel_builds_match_serial(tmp_path, monkeypatch):
    """Locus-parallel haplotype builds (thread pool + buffered log replay)
    must produce byte-identical VCFs to LONGTR_SERIAL_BUILD=1, including
    on loci that exercise the rescue clustering + POA path (noisy reads)."""
    import numpy as np
    from synth import standard_fixture

    fx = standard_fixture(str(tmp_path), rng=np.random.default_rng(5),
                          sub_rate=0.01)
    base = ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--min-reads", "5", "--quiet"]
    par = str(tmp_path / "par.vcf.gz")
    assert cli_main(base + ["--tr-vcf", par]) == 0
    ser = str(tmp_path / "ser.vcf.gz")
    monkeypatch.setenv("LONGTR_SERIAL_BUILD", "1")
    assert cli_main(base + ["--tr-vcf", ser]) == 0
    assert vcf_body(par) == vcf_body(ser)

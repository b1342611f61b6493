"""jax.distributed multi-process path (SURVEY §2.10 / §4).

Two real OS processes initialize ``jax.distributed`` against a local
coordinator (CPU backend), each runs the production CLI on its
``jax.process_index()``-th block shard of the catalog, they join a
coordination-service barrier, and process 0 heap-merges the shard outputs.
The merged VCF must match the single-process run byte for byte (modulo the
##command header, which records the differing argv).
"""

import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(__file__))
from synth import standard_fixture, vcf_body  # noqa: E402

from longtr_tpu.cli import main as cli_main  # noqa: E402


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_distributed_two_process_matches_single(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # inherited by subprocesses
    fx = standard_fixture(str(tmp_path))
    base = ["--bams", ",".join(fx["bams"]), "--fasta", fx["fasta"],
            "--regions", fx["bed"], "--min-reads", "5", "--quiet"]

    whole = str(tmp_path / "whole.vcf.gz")
    stutter1 = str(tmp_path / "stutter1.txt")
    assert cli_main(base + ["--tr-vcf", whole,
                            "--stutter-out", stutter1]) == 0

    multi = str(tmp_path / "multi.vcf.gz")
    stuttern = str(tmp_path / "stuttern.txt")
    port = _free_port()
    procs = []
    for i in range(2):
        argv = base + ["--tr-vcf", multi, "--stutter-out", stuttern,
                       "--distributed",
                       "--coordinator", f"localhost:{port}",
                       "--num-processes", "2", "--process-id", str(i)]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "longtr_tpu.cli"] + argv,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [pr.communicate(timeout=600) for pr in procs]
    for pr, (so, se) in zip(procs, outs):
        assert pr.returncode == 0, se.decode()[-3000:]

    assert vcf_body(multi) == vcf_body(whole)
    assert os.path.exists(multi + ".tbi")
    assert open(stuttern).read() == open(stutter1).read()
    assert not [p for p in os.listdir(tmp_path) if ".shard" in p]

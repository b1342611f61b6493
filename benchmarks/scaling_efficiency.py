"""Multi-host scaling efficiency (BASELINE north star: >=85% at 2 hosts).

Real multi-host hardware is not available here, so "hosts" are emulated the
honest way: each host is an independent OS process pinned to a disjoint,
equal-sized core set with ``taskset`` (the pipeline's thread pools size to
the affinity mask, utils/workers.available_cores).  Host i runs
``--shard i/H`` over the shared catalog — exactly the production multi-host
recipe (parallel/multihost.py) — and the per-shard VCFs are merged with
``longtr-merge-vcf``.

  efficiency(H) = T(1 host) / (H * T(H hosts, concurrent))

where every host has the same core budget, so the only overheads measured
are shard imbalance, shared-resource contention, and the merge.  The merged
H-host VCF is asserted byte-identical to the single-host VCF.

Usage: python benchmarks/scaling_efficiency.py [n_loci] [--hosts H]
       [--cores-per-host C]
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))  # repo root: longtr_tpu without an editable install
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.dirname(__file__))

from loci_throughput import build_catalog  # noqa: E402


from synth import vcf_body  # noqa: E402


def run_hosts(base_argv, out_paths, core_sets, env):
    """Launch one pinned process per host, wait for all; returns wall s."""
    t0 = time.time()
    procs = []
    errfhs = []
    for i, (out, cores) in enumerate(zip(out_paths, core_sets)):
        argv = ["taskset", "-c", cores, sys.executable, "-m",
                "longtr_tpu.cli"] + base_argv + ["--tr-vcf", out]
        if len(out_paths) > 1:
            # block shards: each host's BAM-window/FASTA IO stays
            # proportional to its share (interleave touches ~every window
            # of the whole catalog per host: 0.52 efficiency at 10k loci)
            argv += ["--shard", f"{i}/{len(out_paths)}",
                     "--shard-mode", "block"]
        # stderr to a temp file, NOT a pipe: with a pipe, a host spewing
        # >64KB while an earlier host is being communicate()d would block
        # on the full pipe and artificially serialize the "hosts"
        errfhs.append(tempfile.TemporaryFile())
        procs.append(subprocess.Popen(argv, env=env,
                                      stdout=subprocess.DEVNULL,
                                      stderr=errfhs[-1]))
    for p in procs:
        p.wait()
    wall = time.time() - t0
    for p, efh in zip(procs, errfhs):
        if p.returncode != 0:
            efh.seek(0)
            sys.stderr.write(efh.read().decode(errors="replace")[-2000:])
        efh.close()
    assert all(p.returncode == 0 for p in procs), \
        [p.returncode for p in procs]
    return wall


def main():
    n_loci = int(sys.argv[1]) if len(sys.argv) > 1 and \
        not sys.argv[1].startswith("-") else 600
    hosts = int(sys.argv[sys.argv.index("--hosts") + 1]) \
        if "--hosts" in sys.argv else 2
    # pin within the CPUs this process may actually use (taskset/cpuset)
    cpu_ids = sorted(os.sched_getaffinity(0))
    cores = int(sys.argv[sys.argv.index("--cores-per-host") + 1]) \
        if "--cores-per-host" in sys.argv else \
        max(1, len(cpu_ids) // hosts)
    assert hosts * cores <= len(cpu_ids), \
        f"need {hosts * cores} schedulable CPUs for disjoint pinning, " \
        f"have {len(cpu_ids)}"

    tmpdir = tempfile.mkdtemp()
    fasta, bed, bams, loci, _ = build_catalog(tmpdir, n_loci)
    base = ["--bams", ",".join(bams), "--fasta", fasta, "--regions", bed,
            "--min-reads", "5", "--quiet"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    core_sets = [",".join(str(cpu_ids[hosts * c + h]) for c in range(cores))
                 for h in range(hosts)]

    # warm (imports paged in, native lib built, any compile cache)
    warm = os.path.join(tmpdir, "warm.vcf.gz")
    run_hosts(base + ["--chrom", loci[0].chrom], [warm], [core_sets[0]], env)

    one = os.path.join(tmpdir, "one.vcf.gz")
    t1 = run_hosts(base, [one], [core_sets[0]], env)
    print(f"1 host  x {cores} cores: {t1:.1f}s  "
          f"({n_loci / t1:.1f} loci/s)", flush=True)

    outs = [os.path.join(tmpdir, f"h{i}.vcf.gz") for i in range(hosts)]
    th = run_hosts(base, outs, core_sets, env)
    print(f"{hosts} hosts x {cores} cores: {th:.1f}s  "
          f"({n_loci / th:.1f} loci/s aggregate)", flush=True)

    merged = os.path.join(tmpdir, "merged.vcf.gz")
    t_m = time.time()
    rc = subprocess.run([sys.executable, "-m", "longtr_tpu.parallel.multihost",
                         "--out", merged] + outs, env=env).returncode
    assert rc == 0
    print(f"merge: {time.time() - t_m:.2f}s", flush=True)
    assert vcf_body(merged) == vcf_body(one), \
        "merged multi-host VCF differs from single-host VCF"

    eff = t1 / (hosts * th)
    print(json.dumps({"metric": "host_scaling_efficiency", "hosts": hosts,
                      "cores_per_host": cores, "n_loci": n_loci,
                      "t_1host_s": round(t1, 2),
                      "t_nhost_s": round(th, 2),
                      "value": round(eff, 3), "unit": "fraction",
                      "vcf_identical": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

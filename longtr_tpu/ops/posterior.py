"""Diplotype posterior computation (the reference's core genotyping kernel).

Reference: ``Genotyper::calc_log_sample_posteriors`` (src/genotyper.cpp:45-83):

    for each read r with sample s:
        for each diplotype (a1, a2):
            P[s, a1, a2] += log( exp(LL[r,a1] + log_p1[r] + log(1/2))
                               + exp(LL[r,a2] + log_p2[r] + log(1/2)) )
    P[s] += genotype prior;  P[s] -= logsumexp(P[s])   (normalize per sample)

with the quirk that read log-likelihoods are clamped at -600 *in place*
(genotyper.cpp:57-58) before use.  Priors (genotyper.cpp:21-43):
homozygote 2/(A(A+1)), heterozygote 1/(A(A+1)); haploid: 1/A and -inf.

Note: the reference accepts a ``read_weights`` vector but does not apply it
inside this function — mate-pair double counting is instead avoided upstream
by summing mate LLs into both entries (seq_stutter_genotyper.cpp:542-559) and
the weight is only honoured here in HipSTR's original code path.  We replicate
the reference behaviour (weights unused in the posterior sum).

Device design: one fused jnp computation per locus batch —
``T = logaddexp(LL+p1, LL+p2)`` outer over (a1, a2), then a segment-sum over
reads grouped by sample.  All log-space, float32 on device with a float64
NumPy oracle for tests.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from longtr_tpu.utils.mathops import LOG_ONE_HALF, int_log

LL_CLAMP = -600.0
# The reference uses -DBL_MAX/2 for impossible haploid heterozygotes
# (genotyper.cpp:31); the host f64 path uses the same value (bit parity).
# It becomes -inf when cast to float32 for the device path, which is
# equally absorbing under exp/logsumexp.  Padded cells in batched dispatch
# use the f32-finite NEG_PAD instead.
NEG_HALF_DBL_MAX = -8.988465674311579e307
NEG_PAD = -1e30


def genotype_log_priors(num_alleles: int, haploid: bool) -> np.ndarray:
    """(A, A) log prior matrix (genotyper.cpp:21-43)."""
    A = num_alleles
    if haploid:
        homo = -int_log(A)
        het = NEG_HALF_DBL_MAX
    else:
        homo = int_log(2) - int_log(A) - int_log(A + 1)
        het = -int_log(A) - int_log(A + 1)
    prior = np.full((A, A), het, dtype=np.float64)
    np.fill_diagonal(prior, homo)
    return prior


# ---------------------------------------------------------------------------
# Oracle
# ---------------------------------------------------------------------------

def posteriors_oracle(log_aln_probs: np.ndarray, log_p1: np.ndarray,
                      log_p2: np.ndarray, sample_label: np.ndarray,
                      num_samples: int, haploid: bool):
    """Float64 transcription of calc_log_sample_posteriors.

    Returns (posteriors (S,A,A) normalized, sample_total_LLs (S,), total_LL).
    """
    LL = np.clip(np.asarray(log_aln_probs, dtype=np.float64), LL_CLAMP, None)
    R, A = LL.shape
    P = np.tile(genotype_log_priors(A, haploid)[None], (num_samples, 1, 1))
    for r in range(R):
        s = int(sample_label[r])
        t = np.log(np.exp(LL[r][:, None] + log_p1[r] + LOG_ONE_HALF)
                   + np.exp(LL[r][None, :] + log_p2[r] + LOG_ONE_HALF))
        P[s] += t
    totals = np.zeros(num_samples)
    for s in range(num_samples):
        m = P[s].max()
        tot = m + math.log(np.exp(P[s] - m).sum())
        totals[s] = tot
        P[s] -= tot
    return P, totals, float(totals.sum())


# ---------------------------------------------------------------------------
# JAX implementation
# ---------------------------------------------------------------------------

def calc_log_sample_posteriors(log_aln_probs, log_p1, log_p2, sample_label,
                               num_samples: int, prior, read_mask=None):
    """Vectorized posterior computation.

    Parameters
    ----------
    log_aln_probs : (R, A) float — read-vs-haplotype log-likelihoods
    log_p1, log_p2 : (R,) float — phasing factors
    sample_label : (R,) int32
    num_samples : static int
    prior : (A, A) float — output of :func:`genotype_log_priors`
    read_mask : optional (R,) bool — False entries contribute nothing
      (used for padded reads in batched dispatch)

    Returns (posteriors (S, A, A), sample_total_LLs (S,), total_LL).
    """
    LL = jnp.clip(log_aln_probs, LL_CLAMP, None)
    a = LL + log_p1[:, None] + LOG_ONE_HALF          # (R, A)
    b = LL + log_p2[:, None] + LOG_ONE_HALF          # (R, A)
    T = jnp.logaddexp(a[:, :, None], b[:, None, :])  # (R, A, A)
    if read_mask is not None:
        T = jnp.where(read_mask[:, None, None], T, 0.0)
    S = jax.ops.segment_sum(T, sample_label, num_segments=num_samples)
    P = S + prior[None]
    totals = jax.scipy.special.logsumexp(P.reshape(num_samples, -1), axis=1)
    P = P - totals[:, None, None]
    return P, totals, totals.sum()


@functools.lru_cache(maxsize=None)
def _batched_posterior_fn(S_max: int):
    """Stable jitted (vmapped) posterior fn per S_max: a fresh closure per
    call would defeat jax.jit's trace cache and re-lower every window."""
    def one(LLi, p1i, p2i, labi, maski, pri):
        return calc_log_sample_posteriors(LLi, p1i, p2i, labi, S_max, pri,
                                          read_mask=maski)
    return jax.jit(jax.vmap(one))


def batched_posteriors(loci, mesh=None):
    """One device dispatch computing posteriors for a WINDOW of loci.

    ``loci``: list of dicts with keys ``log_aln_probs`` (R_i, A_i),
    ``log_p1``/``log_p2`` (R_i,), ``sample_label`` (R_i,), ``num_samples``
    S_i, ``haploid``.  Each locus is padded to (R_max, A_max, S_max); padded
    alleles get prior/LL of -1e30 (contribute nothing), padded reads are
    masked out.  The batch is vmapped on one device, or sharded over the
    'locus' axis of ``mesh`` — each locus's reduction stays on a single
    device, so results are bit-identical for any mesh size.

    Returns a list of (posteriors (S_i, A_i, A_i), totals (S_i,)) float32.
    """
    L = len(loci)
    R_max = max(l["log_aln_probs"].shape[0] for l in loci)
    A_max = max(l["log_aln_probs"].shape[1] for l in loci)
    S_max = max(l["num_samples"] for l in loci)
    LL = np.full((L, R_max, A_max), NEG_PAD, dtype=np.float32)
    p1 = np.zeros((L, R_max), dtype=np.float32)
    p2 = np.zeros((L, R_max), dtype=np.float32)
    label = np.zeros((L, R_max), dtype=np.int32)
    mask = np.zeros((L, R_max), dtype=bool)
    prior = np.full((L, A_max, A_max), NEG_PAD, dtype=np.float32)
    for i, l in enumerate(loci):
        R, A = l["log_aln_probs"].shape
        LL[i, :R, :A] = l["log_aln_probs"]
        p1[i, :R] = l["log_p1"]
        p2[i, :R] = l["log_p2"]
        label[i, :R] = l["sample_label"]
        mask[i, :R] = True
        prior[i, :A, :A] = np.maximum(genotype_log_priors(A, l["haploid"]),
                                      NEG_PAD)

    fn = _batched_posterior_fn(S_max)
    if mesh is not None and mesh.devices.size > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        ndev = mesh.devices.size
        pad = (-L) % ndev
        if pad:
            LL = np.pad(LL, ((0, pad), (0, 0), (0, 0)),
                        constant_values=NEG_PAD)
            p1 = np.pad(p1, ((0, pad), (0, 0)))
            p2 = np.pad(p2, ((0, pad), (0, 0)))
            label = np.pad(label, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
            prior = np.pad(prior, ((0, pad), (0, 0), (0, 0)),
                           constant_values=NEG_PAD)
        axis = "locus" if "locus" in mesh.axis_names else mesh.axis_names[0]
        shard = lambda a: jax.device_put(
            a, NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1)))))
        args = tuple(map(shard, (LL, p1, p2, label, mask, prior)))
        P_all, totals, _ = fn(*args)
    else:
        P_all, totals, _ = fn(LL, p1, p2, label, mask, prior)
    P_all = np.asarray(P_all)
    totals = np.asarray(totals)
    out = []
    for i, l in enumerate(loci):
        A = l["log_aln_probs"].shape[1]
        S = l["num_samples"]
        out.append((P_all[i, :S, :A, :A], totals[i, :S]))
    return out


def map_genotypes(posteriors):
    """Per-sample argmax diplotype (genotyper.cpp:85-100).

    Returns (gt_a (S,), gt_b (S,)) with ties broken toward the smallest flat
    index, matching the reference's strict ``>`` scan order.
    """
    S, A, _ = posteriors.shape
    flat = posteriors.reshape(S, -1)
    idx = jnp.argmax(flat, axis=1)
    return idx // A, idx % A

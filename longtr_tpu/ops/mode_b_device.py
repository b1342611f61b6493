"""Device (jit/scan) kernel for mode-B flank scoring.

Reference: ``HapAligner::align_seq_to_hap_short`` (HapAligner.cpp:27-163).
SURVEY §7.2 L3'(d): the mode-B short path gets a device variant.

Design — same split as the mode-A pair-HMM ("emissions host-side, DP on
device"): the intricate per-(j, D) stutter-artifact scores
(StutterAlignerClass marginalization, host transcription in
ops/stutter_hmm.py) are precomputed on host into a dense table
``A[b, s, d, j]``; the device then runs the whole row-DP — flank rows via
the same decayed-running-max closed form as mode A, the stutter row as a
masked gather + term-dropping LSE over artifact sizes — for ALL
(read-segment × haplotype-config × side) elements in ONE ``lax.scan``
dispatch, returning the per-row LAST-COLUMN match vectors that
``ModeBAligner.compute_aln_logprob`` (pipeline/mode_b.py) consumes for the
f64 seed marginalization.

Row kinds (precomputed per element per row on host):
  0 flank row            — M/I/D recurrence (HapAligner.cpp:120-158)
  1 flank after stutter  — match-only recurrence (:132-141); I/D IMPOSSIBLE
  2 stutter row          — artifact-size LSE (:75-113)
  3 skip / padding       — carry M,D through (repeat-block interior rows)

In float64 on CPU the scan is elementwise-identical to the host numpy path
(same association order everywhere; max/cummax are order-exact); production
runs float32 on the default device, the GPU where there is one (tests bound
the drift against the f64 host path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from longtr_tpu.ops.stutter_hmm import IMPOSSIBLE
from longtr_tpu.utils.mathops import LOG_THRESH


@partial(jax.jit, static_argnames=("n_d",))
def mode_b_cols(codes, quals, lw_tab, lc_tab, prefix, last, hapchar, kind,
                stut_ord, A, bl, d0, dstep, params, *, n_d):
    """Last-column match vectors for a batch of mode-B alignments.

    codes/quals: (B, L) uint8 read base codes and qual BYTES; the per-base
      log-wrong/correct values are gathered on device from the 256-entry
      lw_tab/lc_tab (same clamped table base_quality.py reads on host, so
      the gathered values are bitwise identical) — byte wire formats
      because the host->device transfer dominates dispatch cost.
    prefix: (B, L) host-computed sequential prefix = [0, cumsum(blc)[:-1]].
    last: (B,) index of the final valid column (segment length - 1).
    hapchar/kind/stut_ord: (B, R) uint8 per-row char code, row kind,
      stutter ordinal (which slice of ``A`` a kind-2 row uses).
    A: (B, S, n_d, L) host-precomputed artifact scores
       log_prob_pcr_artifact(opt, D) + StutterAligner.align(...), IMPOSSIBLE
       where base_len < 0, -inf in d-padding (dropped by the LSE threshold).
    bl/d0/dstep: (B, S) repeat-block length, first artifact size (max_del)
      and artifact stride (period) per stutter ordinal.
    params: (7,) [i2i, i2m, d2d, d2m, m2m, m2i, m2d] transition scores.

    Returns (B, R) M[row, last-column] in the input dtype.
    """
    B, L = codes.shape
    codes = codes.astype(jnp.int32)
    hapchar = hapchar.astype(jnp.int32)
    kind = kind.astype(jnp.int32)
    stut_ord = stut_ord.astype(jnp.int32)
    qi = quals.astype(jnp.int32)
    blw = lw_tab[qi]
    blc = lc_tab[qi]
    dtype = blc.dtype
    i2i, i2m, d2d, d2m, m2m, m2i, m2d = [params[i] for i in range(7)]
    jj = jnp.arange(L, dtype=dtype)
    jcol = jnp.arange(L, dtype=jnp.int32)
    NEGROW = jnp.full((B, L), IMPOSSIBLE, dtype)
    thresh = jnp.asarray(LOG_THRESH, dtype)

    emit0 = jnp.where(codes == hapchar[:, :1], blc, blw)
    M0 = emit0 + prefix
    D0 = NEGROW

    def step(carry, xs):
        M_prev, D_prev = carry
        hch, knd, sord = xs
        emit = jnp.where(codes == hch[:, None], blc, blw)

        # --- kind 0: full flank recurrence -------------------------------
        d_col0 = jnp.maximum(D_prev[:, 0] + d2d, M_prev[:, 0] + d2m)
        # I[h,j] closed form: src[0] = I[h,0]-blc[0] = 0, src[j>=1] =
        # M[h-1,j-1]+i2m; run = cummax(src - prefix - j*i2i)
        src = jnp.concatenate(
            [jnp.zeros((B, 1), dtype), M_prev[:, :-1] + i2m], axis=1)
        run = jax.lax.cummax(src - prefix - jj * i2i, axis=1)
        I = blc + prefix + jj * i2i + run
        I = I.at[:, 0].set(blc[:, 0])
        M_fl = jnp.concatenate(
            [emit[:, :1],
             emit[:, 1:] + jnp.maximum(
                 I[:, :-1] + m2i,
                 jnp.maximum(M_prev[:, :-1] + m2m, D_prev[:, :-1] + m2d))],
            axis=1)
        D_fl = jnp.concatenate(
            [d_col0[:, None],
             jnp.maximum(M_prev[:, 1:] + d2m, D_prev[:, 1:] + d2d)], axis=1)

        # --- kind 1: match-only row after a stutter block ----------------
        M_as = jnp.concatenate(
            [emit[:, :1], emit[:, 1:] + M_prev[:, :-1]], axis=1)

        # --- kind 2: stutter row -----------------------------------------
        A_r = jnp.take_along_axis(A, sord[:, None, None, None], axis=1)[:, 0]
        bl_r = jnp.take_along_axis(bl, sord[:, None], axis=1)      # (B,1)
        d0_r = jnp.take_along_axis(d0, sord[:, None], axis=1)
        dstep_r = jnp.take_along_axis(dstep, sord[:, None], axis=1)
        dv = d0_r[:, :, None] + (jnp.arange(n_d, dtype=jnp.int32)[None, :, None]
                                 * dstep_r[:, :, None])            # (B,nD,1)
        idx = jcol[None, None, :] - bl_r[:, :, None] - dv          # (B,nD,L)
        ok = (idx >= 0) & (idx <= jcol[None, None, :])
        gathered = jnp.take_along_axis(
            jnp.broadcast_to(M_prev[:, None, :], idx.shape),
            jnp.clip(idx, 0, L - 1), axis=2)
        pre = jnp.where(ok, gathered, jnp.zeros((), dtype))
        terms = A_r + pre
        m = jnp.max(terms, axis=1)                                 # (B, L)
        acc = jnp.zeros((B, L), dtype)
        for d in range(n_d):  # static unroll: sequential sum order, exactly
            diff = terms[:, d] - m  # fast_lse's left-to-right term dropping
            acc = acc + jnp.where(diff > thresh, jnp.exp(diff),
                                  jnp.zeros((), dtype))
        M_st = m + jnp.log(acc)

        k = knd[:, None]
        M_new = jnp.where(k == 0, M_fl,
                          jnp.where(k == 1, M_as,
                                    jnp.where(k == 2, M_st, M_prev)))
        D_new = jnp.where(k == 0, D_fl,
                          jnp.where(k == 3, D_prev, NEGROW))
        col = jnp.take_along_axis(M_new, last[:, None], axis=1)[:, 0]
        return (M_new, D_new), col

    xs = (hapchar.T[1:], kind.T[1:], stut_ord.T[1:])
    _, cols = jax.lax.scan(step, (M0, D0), xs)
    col0 = jnp.take_along_axis(M0, last[:, None], axis=1)[:, 0]
    return jnp.concatenate([col0[None], cols], axis=0).T


def _pad_to(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)

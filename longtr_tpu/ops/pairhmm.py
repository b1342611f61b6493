"""Batched pair-HMM (mode A) for read-vs-haplotype scoring on the device.

Reference semantics: ``HapAligner::align_seq_to_hap``
(src/SeqAlignment/HapAligner.cpp:236-343) — a 3-matrix (M/I/D) max-product DP
over (haplotype position i, read position j) with

* fixed float emissions  MATCH = -0.000100005, MISMATCH = -9.0
  (HapAligner.cpp:260-261),
* 7 log transition parameters, Dindel defaults
  (HapAligner.h:118: ins->ins -1.0, ins->match -0.458675, del->del -1.0,
  del->match -0.458675, match->match -0.00005800168,
  match->ins = match->del = -10.448214728),
* shortcut |n-m| > 600  ->  -700            (HapAligner.cpp:249-252),
* haplotype (untrimmed) length <= 60 -> -1e9 (HapAligner.cpp:241-244),
* per-row band abort: if max_j(best(i,j) + |(n-m)-(i-j)|*del2del) < -600 for
  any row i>=1 the score is -700               (HapAligner.cpp:282-307),
* result = max(M, I, D) at the (n-1, m-1) corner (HapAligner.cpp:309).

Row-scan design
---------------
The reference iterates cell by cell.  Here the DP is re-shaped into a scan
over haplotype rows where every row is computed with vectorized ops over
(batch, read_len):

*  M[i, :] and I[i, :] depend only on row i-1  -> pure elementwise + shift;
*  D[i, j] = max(M[i, j-1] + m2d, D[i, j-1] + d2d) is a *decayed running max*
   along the row: with c[k] = M[i, k] + m2d - (k+1)*d2d,
   D[i, j] = j*d2d + max_{k<=j-1} c[k], i.e. one ``lax.cummax`` per row.

So no anti-diagonal wavefront is needed at all; each scan step is a dense
(batch, M) vector op.  The data-dependent
early abort becomes a flag reduced across rows (same output, no branch).

Boundary-condition quirks of the reference are reproduced deliberately:

* row 0 emissions compare hap[j] against read[0] (HapAligner.cpp:268) — the
  index runs over the *read* axis but indexes the haplotype.  For j >= n the
  reference reads past the string (UB); we score those cells as MISMATCH,
  which the padded comparison yields naturally.
* column 0 emissions compare hap[0] against read[1] for every row
  (HapAligner.cpp:276), not read[0].

Every product of a loop index and a transition (``k * d2d``, ``k * i2i``)
is computed once on the host (:func:`ramps`) and read from a table inside
the loop.  The loop body then holds only max and add, so no compiler can
contract a product into an add (an FMA rounds once where the native
scorer rounds twice), and the scan, the native f32 scorer and the CUDA
kernel agree bit for bit.

Scores are float32 on device; a float64 NumPy oracle
(:func:`pairhmm_score_oracle`) transcribes the C++ loop exactly for testing.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

IMPOSSIBLE = -1000000000.0  # HapAligner.cpp:20
MATCH_EMIT = -0.000100005   # HapAligner.cpp:261 (float)
MISMATCH_EMIT = -9.0        # HapAligner.cpp:260 (float)
BAND_FAIL_SCORE = -700.0
BAND_THRESH = -600.0
LEN_DIFF_LIMIT = 600
MIN_FULL_HAP_LEN = 60       # full (untrimmed) haplotype length gate

# Reference flank geometry (HaplotypeGenerator.h:70, hipstr_main.cpp:140):
REF_FLANK_LEN = 35
DEF_INDEL_FLANK_LEN = 5


@dataclass(frozen=True)
class AlignmentParams:
    """The 7 log transition parameters (HapAligner.h:12-37).

    Defaults are the Dindel values used for Illumina + PacBio HiFi
    (HapAligner.h:118). ``--alignment-params`` supplies all seven.
    """

    ins_to_ins: float = -1.0
    ins_to_match: float = -0.458675
    del_to_del: float = -1.0
    del_to_match: float = -0.458675
    match_to_match: float = -0.00005800168
    match_to_ins: float = -10.448214728
    match_to_del: float = -10.448214728

    @staticmethod
    def from_list(vals):
        vals = list(vals)
        if len(vals) != 7:
            raise ValueError("alignment-params requires exactly 7 values")
        return AlignmentParams(*[float(v) for v in vals])

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.ins_to_ins, self.ins_to_match, self.del_to_del,
             self.del_to_match, self.match_to_match, self.match_to_ins,
             self.match_to_del], dtype=np.float32)


# ---------------------------------------------------------------------------
# Float64 oracle — a faithful transcription of HapAligner.cpp:236-343.
# ---------------------------------------------------------------------------

def pairhmm_score_oracle(hap: str, read: str, params: AlignmentParams = AlignmentParams(),
                         full_hap_len: int | None = None) -> float:
    """Score one (haplotype, read) pair exactly as the reference C++ does.

    ``hap`` is the *trimmed* haplotype sequence (repeat +/- INDEL_FLANK_LEN),
    i.e. what remains after HapAligner.cpp:246 strips
    ``REF_FLANK_LEN - INDEL_FLANK_LEN`` from both ends.  ``full_hap_len`` is
    the untrimmed length used for the <=60 gate; if None it is inferred as
    ``len(hap) + 2*(REF_FLANK_LEN - DEF_INDEL_FLANK_LEN)``.
    """
    if full_hap_len is None:
        full_hap_len = len(hap) + 2 * (REF_FLANK_LEN - DEF_INDEL_FLANK_LEN)
    if full_hap_len <= MIN_FULL_HAP_LEN:
        return IMPOSSIBLE

    n, m = len(hap), len(read)
    if abs(n - m) > LEN_DIFF_LIMIT:
        return BAND_FAIL_SCORE

    i2i = np.float32(params.ins_to_ins)
    i2m = np.float32(params.ins_to_match)
    d2d = np.float32(params.del_to_del)
    d2m = np.float32(params.del_to_match)
    m2m = np.float32(params.match_to_match)
    m2i = np.float32(params.match_to_ins)
    m2d = np.float32(params.match_to_del)
    MA, MI = np.float32(MATCH_EMIT), np.float32(MISMATCH_EMIT)

    M = np.full((n, m), IMPOSSIBLE, dtype=np.float64)
    I = np.full((n, m), IMPOSSIBLE, dtype=np.float64)
    D = np.full((n, m), IMPOSSIBLE, dtype=np.float64)

    M[0, 0] = MA if hap[0] == read[0] else MI
    # Row 0 (HapAligner.cpp:267-272). NOTE the hap[j]-vs-read[0] quirk; the
    # reference reads hap out of bounds when j >= n (UB) — we treat those as
    # mismatches.
    # left_prob is a DOUBLE accumulator in the reference; it must be an
    # np.float64 so NEP50 promotion keeps every expression in f64 (a bare
    # python float is a weak scalar and np.float32 + weak -> float32).
    left = np.float64(0.0)
    for j in range(1, m):
        emit = MA if (j < n and hap[j] == read[0]) else MI
        D[0, j] = m2d + left
        M[0, j] = D[0, j - 1] + d2m + emit
        I[0, j] = IMPOSSIBLE
        left += d2d
    # Column 0 (HapAligner.cpp:274-280). NOTE hap[0]-vs-read[1] quirk.
    left = np.float64(0.0)
    col0_read = read[1] if m > 1 else read[0]
    for i in range(1, n):
        emit = MA if hap[0] == col0_read else MI
        M[i, 0] = I[i - 1, 0] + i2m + emit
        # MATCH + LOG_MATCH_TO_INS is float+float in the reference
        # (HapAligner.cpp:277) before the double accumulator joins
        I[i, 0] = np.float32(MA + m2i) + left
        D[i, 0] = IMPOSSIBLE
        left += i2i

    for i in range(1, n):
        row_best = IMPOSSIBLE
        for j in range(1, m):
            emit = MA if hap[i] == read[j] else MI
            M[i, j] = emit + max(M[i - 1, j - 1] + m2m,
                                 D[i - 1, j - 1] + d2m,
                                 I[i - 1, j - 1] + i2m)
            I[i, j] = MA + max(M[i - 1, j] + m2i, I[i - 1, j] + i2i)
            D[i, j] = max(M[i, j - 1] + m2d, D[i, j - 1] + d2d)
            best = max(M[i, j], I[i, j], D[i, j])
            cand = best + abs((n - m) - (i - j)) * d2d
            if cand > row_best:
                row_best = cand
        if row_best < BAND_THRESH:
            return BAND_FAIL_SCORE

    return float(max(M[n - 1, m - 1], I[n - 1, m - 1], D[n - 1, m - 1]))


# ---------------------------------------------------------------------------
# Batched JAX implementation (row-scan + cummax).
# ---------------------------------------------------------------------------

def encode_seq(seq: str, length: int, pad_code: int = 0) -> np.ndarray:
    """ASCII-encode a sequence into a fixed-length uint8 vector."""
    arr = np.full(length, pad_code, dtype=np.uint8)
    b = seq.encode("ascii")
    arr[: len(b)] = np.frombuffer(b, dtype=np.uint8)
    return arr


def ramps(trans, n_max: int, m_max: int):
    """Host f32 tables ``k * d2d`` (k < 2*max(N, M) + 2) and ``k * i2i``
    (k < N): every product the scan needs, each rounded once as the
    native scorer rounds it."""
    trans = np.asarray(trans, dtype=np.float32)
    size = 2 * max(n_max, m_max) + 2
    return (np.arange(size, dtype=np.float32) * trans[2],
            np.arange(max(n_max, 1), dtype=np.float32) * trans[0])


def pairhmm_scan(hap, hap_len, read, read_len, full_hap_len, trans,
                 d2d_ramp, i2i_ramp):
    """Core scan (jit-friendly). Shapes: hap (B, N), read (B, M); lens (B,);
    ramps from :func:`ramps`.  Returns (B,) float32 scores."""
    B, Mdim = read.shape
    n_max = hap.shape[1]
    i2i, i2m, _, d2m, m2m, m2i, m2d = [trans[k] for k in range(7)]
    MA = jnp.float32(MATCH_EMIT)
    MI = jnp.float32(MISMATCH_EMIT)
    NEG = jnp.float32(IMPOSSIBLE)

    j_idx = jnp.arange(Mdim, dtype=jnp.int32)[None, :]           # (1, M)
    n = hap_len[:, None].astype(jnp.int32)                        # (B, 1)
    m = read_len[:, None].astype(jnp.int32)                       # (B, 1)
    valid_j = j_idx < m                                           # (B, M)

    r0 = read[:, 0:1]                                             # (B, 1)
    # Row 0 closed forms (see oracle). Padded hap positions never match.
    emit_row0 = jnp.where(hap[:, :Mdim] == r0, MA, MI) if hap.shape[1] >= Mdim \
        else jnp.where(jnp.pad(hap, ((0, 0), (0, Mdim - hap.shape[1])),
                               constant_values=0) == r0, MA, MI)
    # D[0, j] = m2d + (j-1)*d2d; the j == 0 slot (NEG) wraps to index -1
    Dk = jnp.where(j_idx >= 1, m2d + jnp.roll(d2d_ramp[:Mdim], 1)[None, :], NEG)
    M0 = jnp.where(
        j_idx == 0,
        jnp.where(hap[:, 0:1] == r0, MA, MI),
        jnp.roll(Dk, 1, axis=-1) + d2m + emit_row0)
    # Derive from inputs (not fresh constants) so the scan carry keeps the
    # device-varying annotation under shard_map.
    I0 = jnp.where(valid_j, NEG, NEG)
    M0 = jnp.where(valid_j, M0, NEG)
    D0 = jnp.where(valid_j, Dk, NEG)

    # Column-0 emission uses read[1] for every row (reference quirk).
    col0_read = jnp.where(m[:, 0] > 1, read[:, 1], read[:, 0])    # (B,)
    col0_emit = jnp.where(hap[:, 0] == col0_read, MA, MI)         # (B,)

    corner_j = jnp.clip(m[:, 0] - 1, 0, Mdim - 1)
    take_corner = lambda row: jnp.take_along_axis(row, corner_j[:, None], axis=1)[:, 0]

    corner0 = jnp.maximum(jnp.maximum(take_corner(M0), take_corner(I0)), take_corner(D0))
    out0 = jnp.where(n[:, 0] == 1, corner0, NEG)

    hap_rows = hap.T                                              # (N, B)

    ramp_j = d2d_ramp[None, :Mdim]                                # j * d2d
    ramp_j1 = d2d_ramp[None, 1:Mdim + 1]                          # (j+1) * d2d

    def body(carry, xs):
        Mp, Ip, Dp, out, bandfail = carry
        i, hrow, i_ramp = xs                     # scalar, (B,), (i-1) * i2i
        emit = jnp.where(hrow[:, None] == read, MA, MI)           # (B, M)

        shift = lambda x: jnp.concatenate([jnp.full((B, 1), NEG), x[:, :-1]], axis=1)
        Mn = emit + jnp.maximum(jnp.maximum(shift(Mp) + m2m, shift(Dp) + d2m),
                                shift(Ip) + i2m)
        In = MA + jnp.maximum(Mp + m2i, Ip + i2i)
        # Column-0 boundary overrides.
        M_col0 = Ip[:, 0] + i2m + col0_emit
        I_col0 = MA + m2i + i_ramp
        Mn = Mn.at[:, 0].set(M_col0)
        In = In.at[:, 0].set(I_col0)
        # D row: decayed running max via cummax.
        c = Mn + m2d - ramp_j1
        cmax = jax.lax.cummax(c, axis=1)
        Dn = jnp.concatenate(
            [jnp.full((B, 1), NEG), ramp_j[:, 1:] + cmax[:, :-1]], axis=1)

        Mn = jnp.where(valid_j, Mn, NEG)
        In = jnp.where(valid_j, In, NEG)
        Dn = jnp.where(valid_j, Dn, NEG)

        best = jnp.maximum(jnp.maximum(Mn, In), Dn)
        band = d2d_ramp[jnp.abs((n - m) - (i - j_idx))]
        band_mask = (j_idx >= 1) & (j_idx <= m - 1)
        row_best = jnp.max(jnp.where(band_mask, best + band, NEG), axis=1)
        row_active = i <= n[:, 0] - 1
        bandfail = bandfail | (row_active & (row_best < BAND_THRESH))

        corner = take_corner(best)
        out = jnp.where(i == n[:, 0] - 1, corner, out)

        keep = row_active[:, None]
        Mn = jnp.where(keep, Mn, Mp)
        In = jnp.where(keep, In, Ip)
        Dn = jnp.where(keep, Dn, Dp)
        return (Mn, In, Dn, out, bandfail), None

    init = (M0, I0, D0, out0, hap_len < 0)
    ii = jnp.arange(1, n_max, dtype=jnp.int32)
    (Mf, If, Df, out, bandfail), _ = jax.lax.scan(
        body, init, (ii, hap_rows[1:n_max], i2i_ramp[:n_max - 1]))

    score = jnp.where(bandfail, jnp.float32(BAND_FAIL_SCORE), out)
    score = jnp.where(jnp.abs(n[:, 0] - m[:, 0]) > LEN_DIFF_LIMIT,
                      jnp.float32(BAND_FAIL_SCORE), score)
    score = jnp.where(full_hap_len <= MIN_FULL_HAP_LEN, NEG, score)
    return score


def pairhmm_batch(hap_codes, hap_lens, read_codes, read_lens, full_hap_lens,
                  params: AlignmentParams = AlignmentParams()):
    """Score a padded batch of (haplotype, read) pairs with the scan.

    Parameters
    ----------
    hap_codes : (B, N) uint8 — trimmed haplotype sequences, 0-padded
    hap_lens : (B,) int32
    read_codes : (B, M) uint8 — trimmed read sequences, 0-padded
    read_lens : (B,) int32
    full_hap_lens : (B,) int32 — untrimmed haplotype lengths (<=60 gate)

    Returns (B,) float32 scores identical (up to f32 rounding) to running
    ``align_seq_to_hap`` per pair, and bit-identical to the native scorer.
    """
    trans = params.as_array()
    d2d_ramp, i2i_ramp = ramps(trans, np.shape(hap_codes)[1],
                               np.shape(read_codes)[1])
    return _pairhmm_scan_jit(
        jnp.asarray(hap_codes), jnp.asarray(hap_lens, dtype=jnp.int32),
        jnp.asarray(read_codes), jnp.asarray(read_lens, dtype=jnp.int32),
        jnp.asarray(full_hap_lens, dtype=jnp.int32), jnp.asarray(trans),
        jnp.asarray(d2d_ramp), jnp.asarray(i2i_ramp))


_pairhmm_scan_jit = jax.jit(pairhmm_scan)


def pairhmm_device(hap_codes, hap_lens, read_codes, read_lens, full_hap_lens,
                   params: AlignmentParams = AlignmentParams()):
    """The single-device path (asynchronous: returns a device array): the
    CUDA kernel on a GPU, the scan elsewhere."""
    from longtr_tpu import placement
    if not placement.on_accelerator():
        return pairhmm_batch(hap_codes, hap_lens, read_codes, read_lens,
                             full_hap_lens, params)
    from longtr_tpu.ops.pairhmm_cuda import pairhmm_cuda_jit
    return pairhmm_cuda_jit(
        jnp.asarray(hap_codes, dtype=jnp.uint8),
        jnp.asarray(hap_lens, dtype=jnp.int32),
        jnp.asarray(read_codes, dtype=jnp.uint8),
        jnp.asarray(read_lens, dtype=jnp.int32),
        jnp.asarray(full_hap_lens, dtype=jnp.int32),
        jnp.asarray(params.as_array()))


def pairhmm_batch_auto(hap_codes, hap_lens, read_codes, read_lens,
                       full_hap_lens, params: AlignmentParams = AlignmentParams(),
                       route: str | None = None):
    """Score a batch where the placement rule puts it.

    ``route`` (default: :func:`longtr_tpu.placement.pairhmm_route`) picks
    the GPU path, that path sharded over a mesh, or the host scorer.  A
    device failure propagates; nothing here re-scores on the host.
    """
    from longtr_tpu import placement
    route = route or placement.pairhmm_route()
    if route == placement.MESH:
        from longtr_tpu.parallel.mesh import pairhmm_batch_sharded
        return pairhmm_batch_sharded(hap_codes, hap_lens, read_codes,
                                     read_lens, full_hap_lens, params)
    if route == placement.DEVICE:
        return pairhmm_device(hap_codes, hap_lens, read_codes, read_lens,
                              full_hap_lens, params)
    return pairhmm_batch_host(hap_codes, hap_lens, read_codes, read_lens,
                              full_hap_lens, params)


def pairhmm_batch_host(hap_codes, hap_lens, read_codes, read_lens,
                       full_hap_lens, params: AlignmentParams = AlignmentParams()):
    """Host scorer: native C++ threaded over the batch (bit-identical to
    the scan), the scan on the CPU backend if the library is missing.

    In reference-fidelity mode scoring runs in float64 (native C++ double
    DP, bit-identical to the compiled reference's align_seq_to_hap; the
    python f64 oracle as fallback) — the path to bit-identical VCF output.
    """
    from longtr_tpu.utils import mathops
    if mathops.ref_fidelity():
        try:
            from longtr_tpu import native
            out = native.pairhmm_batch_native_f64(
                hap_codes, hap_lens, read_codes, read_lens, full_hap_lens,
                params.as_array())
        except Exception:
            out = None
        if out is not None:
            return out
        hap_codes = np.asarray(hap_codes)
        read_codes = np.asarray(read_codes)
        return np.array([
            pairhmm_score_oracle(
                bytes(hap_codes[i, :hap_lens[i]]).decode(),
                bytes(read_codes[i, :read_lens[i]]).decode(),
                params, full_hap_len=int(full_hap_lens[i]))
            for i in range(hap_codes.shape[0])])
    out = _host_batch(hap_codes, hap_lens, read_codes, read_lens,
                      full_hap_lens, params)
    if out is not None:
        return out
    return pairhmm_batch(hap_codes, hap_lens, read_codes, read_lens,
                         full_hap_lens, params)


def _host_batch(hap_codes, hap_lens, read_codes, read_lens, full_hap_lens,
                params):
    """Native C++ batch scorer (threaded; bit-identical to the scan)."""
    try:
        from longtr_tpu import native
        return native.pairhmm_batch_native(
            hap_codes, hap_lens, read_codes, read_lens, full_hap_lens,
            params.as_array())
    except Exception:
        return None

"""Multi-device scaling: locus-sharded data parallelism over a device mesh.

The reference is single-threaded; its only scale-out story is manual
BED-splitting across processes (README.md:78-82).  Here the natural parallel
axis is the (locus × read-pool × haplotype) pair batch: pairs shard across a
1-D ``jax.sharding.Mesh`` ('locus' axis), each device runs the pair-HMM on
its shard, and EM stutter-model sufficient statistics / per-sample posterior
blocks reduce with ``psum`` inside ``shard_map``.  The cards of one host are
joined all to all, so the mesh follows the algorithm alone: one axis over
``jax.devices()``.

The same step runs unchanged on 1 device, N GPUs, or the CPU
``xla_force_host_platform_device_count`` simulation the tests use.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from longtr_tpu.ops.pairhmm import pairhmm_scan, ramps
from longtr_tpu.ops.posterior import LL_CLAMP
from longtr_tpu.utils.mathops import LOG_ONE_HALF

AXIS = "locus"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def shard_batch(mesh: Mesh, *arrays):
    """Place arrays with their leading dim sharded over the mesh."""
    out = []
    for a in arrays:
        spec = P(AXIS, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)))
    return tuple(out)


def pad_to_multiple(arrays, multiple: int, axis: int = 0):
    """Pad leading dim to a multiple (for even sharding). Returns (arrays, n)."""
    n = arrays[0].shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arrays, n
    out = []
    for a in arrays:
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, pad)
        out.append(np.pad(a, widths))
    return tuple(out), n


@lru_cache(maxsize=None)
def _sharded_pairhmm_fn(mesh: Mesh):
    if mesh.devices.flat[0].platform == "gpu":
        from longtr_tpu.ops.pairhmm_cuda import pairhmm_cuda

        def local(h, hl, r, rl, fl, tr, _d2d, _i2i):
            return pairhmm_cuda(h, hl, r, rl, fl, tr)
    else:
        local = pairhmm_scan
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS), P(AXIS),
                      P(), P(), P()),
            out_specs=P(AXIS),
        ))


def sharded_pairhmm(mesh: Mesh, hap, hap_len, read, read_len, full_len, trans,
                    d2d_ramp, i2i_ramp):
    """Pair-HMM over a locus-sharded pair batch: each device runs the
    single-device path on its shard (the CUDA kernel on GPUs, the scan on
    CPU devices).  Scores return sharded."""
    return _sharded_pairhmm_fn(mesh)(hap, hap_len, read, read_len, full_len,
                                     trans, d2d_ramp, i2i_ramp)


def pairhmm_batch_sharded(hap_codes, hap_lens, read_codes, read_lens,
                          full_hap_lens, params, mesh: Mesh | None = None):
    """Mesh-parallel drop-in for ``pairhmm_batch``: pads the pair batch to
    the device grid, shards it over the 'locus' axis and gathers scores.
    Bit-identical to the single-device path element-wise.
    """
    mesh = mesh or make_mesh()
    ndev = mesh.devices.size
    hap = np.asarray(hap_codes, dtype=np.uint8)
    read = np.asarray(read_codes, dtype=np.uint8)
    B = hap.shape[0]
    Bpad = -(-B // ndev) * ndev
    if Bpad != B:
        hap = np.pad(hap, ((0, Bpad - B), (0, 0)))
        read = np.pad(read, ((0, Bpad - B), (0, 0)))
    pad1 = lambda a: np.pad(np.asarray(a, np.int32), (0, Bpad - B),
                            constant_values=1)
    hl, rl, fl = pad1(hap_lens), pad1(read_lens), pad1(full_hap_lens)
    trans = params.as_array()
    d2d_ramp, i2i_ramp = ramps(trans, hap.shape[1], read.shape[1])
    out = sharded_pairhmm(mesh, hap, hl, read, rl, fl, trans, d2d_ramp,
                          i2i_ramp)
    return np.asarray(out)[:B]


def _em_estep_local(LL, log_p1, log_p2, sample_label, valid, cat, w_in,
                    w_out, prior, num_samples: int):
    """Full EM E-step for one read shard with cross-shard psum.

    The production E-step: diplotype posteriors under the
    population-frequency prior, read-phase posteriors, and the seven
    category-binned sufficient statistics the closed-form M step consumes
    (em_stutter_genotyper.cpp:63-168).

    LL (R, A): stutter-PMF read-vs-allele log-likelihoods; cat (R, A) int32
    in {0:in_eq, 1:in_up, 2:in_down, 3:out_up, 4:out_down}; w_in/w_out
    (R, A): |rep| / |eff| magnitudes for the diff-weighted sums.  Reads are
    sharded; the posterior accumulation and the final stats ride psums.
    """
    LLc = jnp.clip(LL, LL_CLAMP, None)
    a = LLc + log_p1[:, None] + LOG_ONE_HALF
    b = LLc + log_p2[:, None] + LOG_ONE_HALF
    T = jnp.logaddexp(a[:, :, None], b[:, None, :])
    T = jnp.where(valid[:, None, None], T, 0.0)
    Ppart = jax.ops.segment_sum(T, sample_label, num_segments=num_samples)
    P = jax.lax.psum(Ppart, AXIS) + prior[None]
    totals = jax.scipy.special.logsumexp(
        P.reshape(num_samples, -1), axis=1)
    Pn = P - totals[:, None, None]

    one = LOG_ONE_HALF + log_p1[:, None, None] + LLc[:, :, None]
    two = LOG_ONE_HALF + log_p2[:, None, None] + LLc[:, None, :]
    tot2 = jnp.logaddexp(one, two)
    Pr = Pn[sample_label]                        # (R, A, A)
    f0 = jax.scipy.special.logsumexp(Pr + (one - tot2), axis=2)   # (R, A)
    f1 = jax.scipy.special.logsumexp(Pr + (two - tot2), axis=1)   # (R, A)
    lin = jnp.exp(f0) + jnp.exp(f1)
    lin = jnp.where(valid[:, None], lin, 0.0)
    sums = jax.ops.segment_sum(lin.reshape(-1), cat.reshape(-1),
                               num_segments=5)
    din = jnp.sum(lin * w_in)
    dout = jnp.sum(lin * w_out)
    stats = jax.lax.psum(jnp.concatenate([sums, jnp.stack([din, dout])]),
                         AXIS)
    return Pn, totals, stats


def em_estep_sharded(mesh: Mesh, LL, log_p1, log_p2, sample_label, valid,
                     cat, w_in, w_out, prior, num_samples: int):
    """Read-sharded production E-step: posteriors replicated via psum,
    category stats all-reduced.  Returns (posteriors (S,A,A), totals (S,),
    stats (7,)) as numpy arrays."""
    ndev = mesh.devices.size
    arrays, R = pad_to_multiple((np.asarray(LL, np.float32),
                                 np.asarray(log_p1, np.float32),
                                 np.asarray(log_p2, np.float32),
                                 np.asarray(sample_label, np.int32),
                                 np.asarray(valid, bool),
                                 np.asarray(cat, np.int32),
                                 np.asarray(w_in, np.float32),
                                 np.asarray(w_out, np.float32)), ndev)
    LLp, p1p, p2p, labp, vp, catp, wip, wop = arrays
    if LLp.shape[0] != R:
        vp = vp.copy()
        vp[R:] = False
    sharded = shard_batch(mesh, LLp, p1p, p2p, labp, vp, catp, wip, wop)
    fn = jax.jit(
        jax.shard_map(
            partial(_em_estep_local, num_samples=num_samples),
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                      P(AXIS, None), P(AXIS, None), P(AXIS, None), P()),
            out_specs=(P(), P(), P()),
        ))
    Pn, totals, stats = fn(*sharded, jnp.asarray(prior, jnp.float32))
    return np.asarray(Pn), np.asarray(totals), np.asarray(stats)


# ---------------------------------------------------------------------------
# Whole-EM device loop: ONE dispatch per locus (train loop as lax.while_loop)
# ---------------------------------------------------------------------------
#
# Dispatching em_estep_sharded once per locus per EM iteration pays a
# launch and a host sync per iteration, and every distinct (R, A) shape
# re-lowers the program.  Here the entire train
# loop — E-step, closed-form M-step, convergence tests
# (em_stutter_genotyper.cpp:170-226) — runs device-side inside a single
# lax.while_loop, reads sharded over the mesh with psum collectives, and
# input shapes are bucketed so XLA compiles once per (R-bucket, A-bucket, S).

_EM_TOL = 1e-10
_EM_MAX_PARAM_DIFF = 1e-4
_EM_LOG11 = float(np.log(1.1))


def _em_pmf_from_params(params, rep, eff, in_frame):
    """log_stutter_pmf over the (R, A) diff tables (stutter_model.cpp:29-53).

    params: (6,) = (in_geom, in_up, in_down, out_geom, out_up, out_down);
    rep / eff: integer repeat- / effective-bp-difference tables; in_frame:
    bool table."""
    ing, inu, ind, outg, outu, outd = (params[i] for i in range(6))
    in_log_step = jnp.log(1.0 - ing)
    in_log_nostep = jnp.log(ing)
    out_log_step = jnp.log(1.0 - outg)
    out_log_nostep = jnp.log(outg)
    log_equal = jnp.log(1.0 - inu - ind - outu - outd)
    out_val = jnp.where(
        eff < 0,
        jnp.log(outd) + out_log_nostep + out_log_step * (-eff - 1),
        jnp.log(outu) + out_log_nostep + out_log_step * (eff - 1))
    in_val = jnp.where(
        rep == 0, log_equal,
        jnp.where(rep < 0,
                  jnp.log(ind) + in_log_nostep + in_log_step * (-rep - 1),
                  jnp.log(inu) + in_log_nostep + in_log_step * (rep - 1)))
    return jnp.where(in_frame, in_val, out_val)


def _em_mstep_params(stats):
    """Closed-form stutter re-estimate from the 7 category sums with the
    reference's pseudocounts (em_stutter_genotyper.cpp:63-127)."""
    s_in_eq, s_in_up, s_in_down, s_out_up, s_out_down, din, dout = (
        stats[i] for i in range(7))
    in_tot_up = jnp.log(1.0 + s_in_up)
    in_tot_down = jnp.log(1.0 + s_in_down)
    in_tot_eq = jnp.log(1.0 + s_in_eq)
    in_tot_diffs = jnp.log(1.0 + 1.1 + din)
    out_tot_up = jnp.log(1.0 + s_out_up)
    out_tot_down = jnp.log(1.0 + s_out_down)
    out_tot_diffs = jnp.log(1.0 + 1.1 + dout)
    out_tot = jnp.logaddexp(out_tot_up, out_tot_down)
    in_pgeom = jnp.minimum(
        0.999, jnp.exp(jnp.logaddexp(in_tot_up, in_tot_down) - in_tot_diffs))
    out_pgeom = jnp.minimum(0.999, jnp.exp(out_tot - out_tot_diffs))
    log_total = jnp.logaddexp(
        jax.scipy.special.logsumexp(
            jnp.stack([in_tot_up, in_tot_down, in_tot_eq])), out_tot)
    return jnp.stack([
        in_pgeom, jnp.exp(in_tot_up - log_total),
        jnp.exp(in_tot_down - log_total), out_pgeom,
        jnp.exp(out_tot_up - log_total), jnp.exp(out_tot_down - log_total)])


def _em_train_local(rep, eff, in_frame, log_p1, log_p2, sample_label, valid,
                    cat, w_in, w_out, init_priors, *, num_samples: int,
                    haploid: bool, max_iter: int, min_abs: float,
                    min_frac: float):
    """Full EM train loop on one read shard (state replicated via psum)."""
    A = rep.shape[1]
    init_params = jnp.array([0.9, 0.1, 0.1, 0.8, 0.01, 0.01], jnp.float32)

    def prior_matrix(priors):
        if haploid:
            m = jnp.full((A, A), -1e30, jnp.float32)
            return jnp.fill_diagonal(m, priors, inplace=False)
        return priors[:, None] + priors[None, :]

    def body(state):
        it, done, converged, LL, priors, params, _Pn, _totals = state
        pmf = _em_pmf_from_params(params, rep, eff, in_frame)
        Pn, totals, stats = _em_estep_local(
            pmf, log_p1, log_p2, sample_label, valid, cat, w_in, w_out,
            prior_matrix(priors), num_samples)
        new_LL = jnp.sum(totals)
        # M step (em_stutter_genotyper.cpp:201-216)
        first = jax.scipy.special.logsumexp(Pn, axis=2)
        c1 = jax.scipy.special.logsumexp(first, axis=0)
        c2 = jax.scipy.special.logsumexp(
            jax.scipy.special.logsumexp(Pn, axis=1), axis=0)
        combined = jnp.logaddexp(c1, c2)
        new_priors = combined - jax.scipy.special.logsumexp(combined)
        new_params = _em_mstep_params(stats)

        nonmono = new_LL < LL + _EM_TOL
        abs_change = new_LL - LL
        frac_change = -(new_LL - LL) / LL
        conv_after = ((abs_change < min_abs) & (frac_change < min_frac)) | \
            jnp.all(jnp.abs(new_params - params) < _EM_MAX_PARAM_DIFF)
        done_now = nonmono | conv_after
        params = jnp.where(nonmono, params, new_params)
        priors = jnp.where(nonmono, priors, new_priors)
        return (it + 1, done | done_now, converged | done_now,
                jnp.float32(new_LL), priors, params, Pn, totals)

    def cond(state):
        it, done, *_ = state
        return (it < max_iter) & ~done

    state = (jnp.int32(0), jnp.bool_(False), jnp.bool_(False),
             jnp.float32(-jnp.inf), init_priors, init_params,
             jnp.zeros((num_samples, A, A), jnp.float32),
             jnp.zeros((num_samples,), jnp.float32))
    (it, done, converged, LL, priors, params, Pn,
     totals) = jax.lax.while_loop(cond, body, state)
    return converged, params, it, Pn, totals


@partial(jax.jit, static_argnames=("num_samples", "haploid", "max_iter",
                                   "min_abs", "min_frac", "mesh"))
def _em_train_jit(rep, eff, in_frame, p1, p2, lab, valid, cat, w_in, w_out,
                  init_priors, *, mesh, num_samples, haploid, max_iter,
                  min_abs, min_frac):
    return jax.shard_map(
        partial(_em_train_local, num_samples=num_samples, haploid=haploid,
                max_iter=max_iter, min_abs=min_abs, min_frac=min_frac),
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS),
                  P(AXIS), P(AXIS), P(AXIS), P(AXIS, None), P(AXIS, None),
                  P(AXIS, None), P()),
        out_specs=(P(), P(), P(), P(), P()),
    )(rep, eff, in_frame, p1, p2, lab, valid, cat, w_in, w_out, init_priors)


def _bucket(n: int, step: int) -> int:
    return max(step, ((n + step - 1) // step) * step)


def em_train_sharded(mesh: Mesh, rep, eff, in_frame, log_p1, log_p2,
                     sample_label, cat, w_in, w_out, init_priors,
                     num_samples: int, haploid: bool, max_iter: int,
                     min_abs: float, min_frac: float):
    """Run the whole EM train loop in ONE device dispatch, reads sharded.

    rep/eff/in_frame/cat/w_in/w_out: (R, A) diff-category tables from
    EMStutterGenotyper (constant across iterations); init_priors: (A,)
    initial population log-frequencies (computed host-side, tiny).
    Returns (converged, params (6,), n_iter, posteriors (S,A,A) from the
    final E-step, totals (S,)) as host values.

    Shapes are bucketed (reads to 64*ndev, alleles to the next even bucket)
    so repeated loci reuse the compiled program; padded alleles carry -inf
    priors and padded reads are masked, neither contributes to posteriors,
    stats, or the LL.
    """
    ndev = mesh.devices.size
    R, A = rep.shape
    Rpad = _bucket(R, 64 * ndev)
    Apad = _bucket(A, 4)
    pad2 = lambda a, fill=0: np.pad(np.asarray(a), ((0, Rpad - R),
                                                    (0, Apad - A)),
                                    constant_values=fill)
    pad1 = lambda a, fill=0: np.pad(np.asarray(a), (0, Rpad - R),
                                    constant_values=fill)
    valid = np.zeros(Rpad, bool)
    valid[:R] = True
    prior_pad = np.full(Apad, -np.inf, np.float32)
    prior_pad[:A] = np.asarray(init_priors, np.float32)
    args = (pad2(rep).astype(np.int32), pad2(eff).astype(np.int32),
            pad2(in_frame).astype(bool),
            pad1(log_p1).astype(np.float32), pad1(log_p2).astype(np.float32),
            pad1(sample_label).astype(np.int32), valid,
            pad2(cat).astype(np.int32), pad2(w_in).astype(np.float32),
            pad2(w_out).astype(np.float32), prior_pad)
    sharded = shard_batch(mesh, *args[:10])
    converged, params, it, Pn, totals = _em_train_jit(
        *sharded, jnp.asarray(args[10]), mesh=mesh, num_samples=num_samples,
        haploid=haploid, max_iter=int(max_iter), min_abs=float(min_abs),
        min_frac=float(min_frac))
    return (bool(converged), np.asarray(params, np.float64), int(it),
            np.asarray(Pn, np.float64)[:, :A, :A],
            np.asarray(totals, np.float64))

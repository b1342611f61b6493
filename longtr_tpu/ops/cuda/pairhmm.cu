// Pair-HMM (mode A) on an NVIDIA GPU, called from JAX through the XLA FFI.
//
// One thread block scores one (haplotype, read) pair and walks the
// haplotype rows in order, as gpuPairHMM does.  Each thread owns a strip of
// C consecutive read columns and keeps their M/I/D state in registers; the
// previous row's value at a strip's left edge comes from the neighbouring
// lane by warp shuffle, or from shared memory across warps.  The deletion
// chain is the closed form of longtr_tpu/ops/pairhmm.py:
//     D[i, j] = j*d2d + max_{k<j} (M[i, k] + m2d - (k+1)*d2d)
// whose prefix max is a warp-shuffle scan plus one exchange of warp maxima.
// A max is exact in any order, and every other operation is the f32 add
// of the scan and of the native scorer (native/longtr_native.cc) in the
// same association order.  Build with --fmad=false: a product contracted
// into an add would round once where those paths round twice.
//
// Rows longer than T*C columns are walked in segments of T*C columns whose
// state lives in a global scratch buffer between segments, stored slot-major
// (column j0 + c of thread t at c*T + t) so that a warp's accesses coalesce;
// the read's codes then sit in shared memory.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float NEG = -1000000000.0f;   // IMPOSSIBLE
constexpr float MA = -0.000100005f;     // MATCH_EMIT
constexpr float MI = -9.0f;             // MISMATCH_EMIT
constexpr float BAND_FAIL = -700.0f;
constexpr float BAND_THRESH = -600.0f;
constexpr int LEN_DIFF_LIMIT = 600;
constexpr int MIN_FULL_HAP_LEN = 60;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float fmax2(float a, float b) {
  return a > b ? a : b;
}

template <int T, int C>
__global__ void __launch_bounds__(T)
    pairhmm_rows(const uint8_t* __restrict__ hap,
                 const int32_t* __restrict__ hap_len,
                 const uint8_t* __restrict__ read,
                 const int32_t* __restrict__ read_len,
                 const int32_t* __restrict__ full_len,
                 const float* __restrict__ trans, int N, int Mdim, int nseg,
                 float* __restrict__ out, float* __restrict__ scratch) {
  constexpr int W = T / 32;
  constexpr int SEG = T * C;
  // s_edge[parity][segment][M/I/D][warp]: each warp's last column of the
  // row of that parity, read by the next warp (and segment) one row later;
  // then, when rows walk in segments, the read's codes.
  extern __shared__ float s_edge[];
  __shared__ float s_wmax[W];
  uint8_t* s_read = reinterpret_cast<uint8_t*>(s_edge + 2 * nseg * 3 * W);

  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = hap_len[b], m = read_len[b];
  if (full_len[b] <= MIN_FULL_HAP_LEN) {
    if (t == 0) out[b] = NEG;
    return;
  }
  if (abs(n - m) > LEN_DIFF_LIMIT) {
    if (t == 0) out[b] = BAND_FAIL;
    return;
  }
  const float i2i = trans[0], i2m = trans[1], d2d = trans[2], d2m = trans[3],
              m2m = trans[4], m2i = trans[5], m2d = trans[6];
  const uint8_t* hb = hap + (size_t)b * N;
  const uint8_t* rb = read + (size_t)b * Mdim;
  const bool resident = nseg == 1;
  const size_t row_stride = (size_t)nseg * SEG;
  float* sM = scratch + (size_t)b * 3 * row_stride;
  float* sI = sM + row_stride;
  float* sD = sI + row_stride;
  // scratch slot of thread t's c-th column in segment s
  auto slot = [&](int s, int c) { return s * SEG + c * T + t; };
  auto edge = [&](int parity, int seg, int k, int w) -> float& {
    return s_edge[((parity * nseg + seg) * 3 + k) * W + w];
  };

  const uint8_t r0 = rb[0];
  const uint8_t col0_read = m > 1 ? rb[1] : rb[0];
  const float col0_emit = hb[0] == col0_read ? MA : MI;

  float M[C], I[C], D[C];
  uint8_t r[C];

  // Row 0 (closed forms; the hap[j]-vs-read[0] quirk reads the padded
  // haplotype codes, as the scan and the native scorer do).
  for (int s = 0; s < nseg; s++) {
    const int j0 = s * SEG + t * C;
#pragma unroll
    for (int c = 0; c < C; c++) {
      const int j = j0 + c;
      if (j < m) {
        const float dk = j >= 1 ? m2d + (float)(j - 1) * d2d : NEG;
        const float dkp = j >= 2 ? m2d + (float)(j - 2) * d2d : NEG;
        const float emit0 = ((j < N ? hb[j] : 0) == r0) ? MA : MI;
        M[c] = j == 0 ? (hb[0] == r0 ? MA : MI) : dkp + d2m + emit0;
        I[c] = NEG;
        D[c] = dk;
      } else {
        M[c] = NEG;
        I[c] = NEG;
        D[c] = NEG;
      }
    }
    if (lane == 31) {
      edge(0, s, 0, warp) = M[C - 1];
      edge(0, s, 1, warp) = I[C - 1];
      edge(0, s, 2, warp) = D[C - 1];
    }
    if (!resident) {
#pragma unroll
      for (int c = 0; c < C; c++) {
        sM[slot(s, c)] = M[c];
        sI[slot(s, c)] = I[c];
        sD[slot(s, c)] = D[c];
      }
    }
  }
  if (resident) {
#pragma unroll
    for (int c = 0; c < C; c++) {
      const int j = t * C + c;
      r[c] = j < Mdim ? rb[j] : 0;
    }
  } else {
    for (int j = t; j < nseg * SEG; j += T) s_read[j] = j < Mdim ? rb[j] : 0;
  }
  __syncthreads();

  uint8_t hc_next = n > 1 ? hb[1] : 0;
  for (int i = 1; i < n; i++) {
    const uint8_t hc = hc_next;
    if (i + 1 < n) hc_next = hb[i + 1];
    const int pp = (i - 1) & 1, p = i & 1;
    const float irow = MA + m2i + (float)(i - 1) * i2i;
    float run = -INFINITY;   // max of c[k] over the segments already done
    bool ok = false;         // some in-band cell reaches BAND_THRESH
    for (int s = 0; s < nseg; s++) {
      const int j0 = s * SEG + t * C;
      if (!resident) {
#pragma unroll
        for (int c = 0; c < C; c++) {
          M[c] = sM[slot(s, c)];
          I[c] = sI[slot(s, c)];
          D[c] = sD[slot(s, c)];
          r[c] = s_read[j0 + c];
        }
      }
      // previous row at column j0 - 1
      float pM = __shfl_up_sync(FULL, M[C - 1], 1);
      float pI = __shfl_up_sync(FULL, I[C - 1], 1);
      float pD = __shfl_up_sync(FULL, D[C - 1], 1);
      if (lane == 0) {
        if (warp > 0) {
          pM = edge(pp, s, 0, warp - 1);
          pI = edge(pp, s, 1, warp - 1);
          pD = edge(pp, s, 2, warp - 1);
        } else if (s > 0) {
          pM = edge(pp, s - 1, 0, W - 1);
          pI = edge(pp, s - 1, 1, W - 1);
          pD = edge(pp, s - 1, 2, W - 1);
        } else {
          pM = pI = pD = NEG;   // column -1: column 0 is overridden
        }
      }
      // M and I rows, right to left so each cell still sees row i-1.
#pragma unroll
      for (int c = C - 1; c >= 0; c--) {
        const int j = j0 + c;
        const float lm = c > 0 ? M[c - 1] : pM;
        const float li = c > 0 ? I[c - 1] : pI;
        const float ld = c > 0 ? D[c - 1] : pD;
        const float emit = hc == r[c] ? MA : MI;
        float mn = emit + fmax2(fmax2(lm + m2m, ld + d2m), li + i2m);
        float in = MA + fmax2(M[c] + m2i, I[c] + i2i);
        if (j == 0) {
          mn = I[0] + i2m + col0_emit;
          in = irow;
        }
        M[c] = mn;
        I[c] = in;
      }
      // D row: exclusive prefix max of c[k] = M[k] + m2d - (k+1)*d2d.
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < C; c++) {
        const float ck = M[c] + m2d - (float)(j0 + c + 1) * d2d;
        tmax = fmax2(tmax, ck);
      }
      float incl = tmax;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl = fmax2(incl, u);
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = -INFINITY;
      if (W > 1) {
        if (lane == 31) s_wmax[warp] = incl;
        __syncthreads();
        float seg_max = -INFINITY;
#pragma unroll
        for (int w = 0; w < W; w++) {
          if (w < warp) excl = fmax2(excl, s_wmax[w]);
          seg_max = fmax2(seg_max, s_wmax[w]);
        }
        excl = fmax2(excl, run);
        run = fmax2(run, seg_max);
      } else {
        excl = fmax2(excl, run);
        run = fmax2(run, __shfl_sync(FULL, incl, 31));
      }
#pragma unroll
      for (int c = 0; c < C; c++) {
        const int j = j0 + c;
        const float ck = M[c] + m2d - (float)(j + 1) * d2d;
        D[c] = j == 0 ? NEG : (float)j * d2d + excl;
        excl = fmax2(excl, ck);
      }
      // masks and the per-row band test
#pragma unroll
      for (int c = 0; c < C; c++) {
        const int j = j0 + c;
        const bool valid = j < m;
        M[c] = valid ? M[c] : NEG;
        I[c] = valid ? I[c] : NEG;
        D[c] = valid ? D[c] : NEG;
        if (j >= 1 && j <= m - 1) {
          const float best = fmax2(fmax2(M[c], I[c]), D[c]);
          const int bd = (n - m) - (i - j);
          const float cand = best + (float)(bd < 0 ? -bd : bd) * d2d;
          ok |= cand >= BAND_THRESH;
        }
      }
      if (lane == 31) {
        edge(p, s, 0, warp) = M[C - 1];
        edge(p, s, 1, warp) = I[C - 1];
        edge(p, s, 2, warp) = D[C - 1];
      }
      if (!resident) {
#pragma unroll
        for (int c = 0; c < C; c++) {
          sM[slot(s, c)] = M[c];
          sI[slot(s, c)] = I[c];
          sD[slot(s, c)] = D[c];
        }
        if (s + 1 < nseg) __syncthreads();
      }
    }
    if (!__syncthreads_or(ok)) {   // the band abort is sticky: score -700
      if (t == 0) out[b] = BAND_FAIL;
      return;
    }
  }

  if (n < 1) {
    if (t == 0) out[b] = NEG;
    return;
  }
  const int cj = m - 1 < 0 ? 0 : (m - 1 >= Mdim ? Mdim - 1 : m - 1);
  if (resident) {
#pragma unroll
    for (int c = 0; c < C; c++)
      if (t * C + c == cj) out[b] = fmax2(fmax2(M[c], I[c]), D[c]);
  } else {
    const int s = cj / SEG, q = cj % SEG;
    if (t == q / C) {
      const int k = slot(s, q % C);
      out[b] = fmax2(fmax2(sM[k], sI[k]), sD[k]);
    }
  }
}

template <int T, int C>
cudaError_t launch(cudaStream_t stream, int B, int nseg,
                   const uint8_t* hap, const int32_t* hl, const uint8_t* read,
                   const int32_t* rl, const int32_t* fl, const float* trans,
                   int N, int Mdim, float* out, float* scratch) {
  size_t smem = 2 * (size_t)nseg * 3 * (T / 32) * sizeof(float);
  if (nseg > 1) smem += (size_t)nseg * T * C;   // the read's codes
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairhmm_rows<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  pairhmm_rows<T, C><<<B, T, smem, stream>>>(hap, hl, read, rl, fl, trans, N,
                                             Mdim, nseg, out, scratch);
  return cudaGetLastError();
}

ffi::Error PairHmmImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> hap,
                       ffi::Buffer<ffi::S32> hap_len,
                       ffi::Buffer<ffi::U8> read,
                       ffi::Buffer<ffi::S32> read_len,
                       ffi::Buffer<ffi::S32> full_len,
                       ffi::Buffer<ffi::F32> trans, int32_t threads,
                       int32_t cols, int32_t nseg,
                       ffi::ResultBuffer<ffi::F32> out,
                       ffi::ResultBuffer<ffi::F32> scratch) {
  const auto hd = hap.dimensions();
  const auto rd = read.dimensions();
  if (hd.size() != 2 || rd.size() != 2 || hd[0] != rd[0])
    return ffi::Error::InvalidArgument("hap and read must be (B, N), (B, M)");
  const int B = (int)hd[0], N = (int)hd[1], Mdim = (int)rd[1];
  if (B == 0) return ffi::Error::Success();
  if (N < 1 || Mdim < 1 || (int64_t)nseg * threads * cols < Mdim)
    return ffi::Error::InvalidArgument("launch shape does not cover the read");
  if (nseg > 1 && scratch->element_count() <
                      (size_t)B * 3 * nseg * threads * cols)
    return ffi::Error::InvalidArgument("scratch too small");
  const uint8_t* h = hap.typed_data();
  const uint8_t* r = read.typed_data();
  const int32_t* hl = hap_len.typed_data();
  const int32_t* rl = read_len.typed_data();
  const int32_t* fl = full_len.typed_data();
  const float* tr = trans.typed_data();
  float* o = out->typed_data();
  float* sc = scratch->typed_data();
  cudaError_t err;
  const int key = threads * 100 + cols;
  switch (key) {
#define LONGTR_CASE(T_, C_)                                                   \
  case T_ * 100 + C_:                                                       \
    err = launch<T_, C_>(stream, B, nseg, h, hl, r, rl, fl, tr, N, Mdim, o, \
                         sc);                                               \
    break;
    LONGTR_CASE(32, 8)
    LONGTR_CASE(64, 8)
    LONGTR_CASE(128, 8)
    LONGTR_CASE(256, 8)
    LONGTR_CASE(256, 16)
    LONGTR_CASE(512, 16)
#undef LONGTR_CASE
    default:
      return ffi::Error::InvalidArgument(
          "no pair-HMM kernel for threads=" + std::to_string(threads) +
          " cols=" + std::to_string(cols));
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("pair-HMM launch failed: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LongtrPairHmm, PairHmmImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("threads")
                                  .Attr<int32_t>("cols")
                                  .Attr<int32_t>("nseg")
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());

// Native host-side I/O acceleration for longtr_tpu.
//
// The reference (gymrek-lab/LongTR) does all I/O through htslib (C);
// this library provides the equivalent native fast paths for our own
// BAM/BGZF implementation:
//   * BGZF: block-size scan + whole-buffer inflation (zlib)
//   * BAM:  batch record decode into columnar arrays (positions, flags,
//           cigar ops, ASCII sequence/quals, field offsets) so Python
//           touches each record O(1) instead of per-byte.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Build: see build.sh (g++ -O3 -shared -fPIC ... -lz).

#include <cctype>
#include <cstdint>
#include <chrono>
#include <cstring>
#include <zlib.h>
#include <atomic>
#include <vector>
#include <thread>
#ifdef __linux__
#include <sched.h>
#endif

// Cores this process may actually run on: hardware_concurrency() reports
// the machine total even under taskset/cgroup pinning (e.g. emulated
// multi-host shards), which oversubscribes a pinned shard.
static unsigned effective_cores() {
#ifdef __linux__
  cpu_set_t s;
  if (sched_getaffinity(0, sizeof(s), &s) == 0) {
    int n = CPU_COUNT(&s);
    if (n > 0) return (unsigned)n;
  }
#endif
  unsigned n = std::thread::hardware_concurrency();
  return n ? n : 4;
}

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

// Sum of ISIZE fields over all BGZF blocks (total uncompressed size).
// Returns -1 on malformed data.
int64_t ltr_bgzf_total_isize(const uint8_t* src, int64_t n) {
  int64_t off = 0;
  int64_t total = 0;
  while (off + 18 <= n) {
    if (src[off] != 0x1f || src[off + 1] != 0x8b) return -1;
    uint16_t xlen = src[off + 10] | (src[off + 11] << 8);
    // find BC subfield
    int64_t xoff = off + 12;
    int64_t xend = xoff + xlen;
    // A window boundary may cut a block inside its extra field; a truncated
    // TAIL is a clean stop (windowed fetch), corruption at offset 0 is not.
    if (xend > n) { if (off == 0) return -1; break; }
    int32_t bsize = -1;
    while (xoff + 4 <= xend) {
      uint8_t si1 = src[xoff], si2 = src[xoff + 1];
      uint16_t slen = src[xoff + 2] | (src[xoff + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        bsize = (src[xoff + 4] | (src[xoff + 5] << 8)) + 1;
        break;
      }
      xoff += 4 + slen;
    }
    if (bsize < 18 || bsize < 12 + (int32_t)xlen + 8) return -1;
    if (off + bsize > n) break;  // truncated trailing block: stop
    uint32_t isize;
    memcpy(&isize, src + off + bsize - 4, 4);
    total += isize;
    off += bsize;
  }
  return total;
}

// Inflate all BGZF blocks in src into dst (capacity dst_cap).
// Returns total decompressed bytes, or -1 on error / -2 if dst too small.
int64_t ltr_bgzf_inflate_all(const uint8_t* src, int64_t n,
                             uint8_t* dst, int64_t dst_cap) {
  int64_t off = 0;
  int64_t out = 0;
  while (off + 18 <= n) {
    if (src[off] != 0x1f || src[off + 1] != 0x8b) return -1;
    uint16_t xlen = src[off + 10] | (src[off + 11] << 8);
    int64_t xoff = off + 12;
    int64_t xend = xoff + xlen;
    // A window boundary may cut a block inside its extra field; a truncated
    // TAIL is a clean stop (windowed fetch), corruption at offset 0 is not.
    if (xend > n) { if (off == 0) return -1; break; }
    int32_t bsize = -1;
    while (xoff + 4 <= xend) {
      uint8_t si1 = src[xoff], si2 = src[xoff + 1];
      uint16_t slen = src[xoff + 2] | (src[xoff + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        bsize = (src[xoff + 4] | (src[xoff + 5] << 8)) + 1;
        break;
      }
      xoff += 4 + slen;
    }
    // bsize must cover header (12 + xlen) + trailer (CRC32 + ISIZE = 8);
    // anything smaller makes clen negative and the (uInt) cast huge.
    if (bsize < 18 || bsize < 12 + (int32_t)xlen + 8) return -1;
    if (off + bsize > n) break;
    const uint8_t* cdata = src + off + 12 + xlen;
    int64_t clen = bsize - 12 - xlen - 8;
    uint32_t isize;
    memcpy(&isize, src + off + bsize - 4, 4);
    if (out + isize > dst_cap) return -2;
    if (isize > 0) {
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) return -1;
      zs.next_in = const_cast<uint8_t*>(cdata);
      zs.avail_in = (uInt)clen;
      zs.next_out = dst + out;
      zs.avail_out = (uInt)isize;
      int ret = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (ret != Z_STREAM_END) return -1;
    }
    out += isize;
    off += bsize;
  }
  return out;
}

// Multithreaded BGZF inflate: BGZF blocks are independent deflate streams,
// so scan once for (src offset, clen, dst offset, isize) then inflate blocks
// in parallel.  Same return convention as ltr_bgzf_inflate_all.
int64_t ltr_bgzf_inflate_mt(const uint8_t* src, int64_t n,
                            uint8_t* dst, int64_t dst_cap, int nthreads);

namespace {
struct BgzfBlock { int64_t coff; int64_t clen; int64_t doff; uint32_t isize; };

static int inflate_one(const uint8_t* cdata, int64_t clen,
                       uint8_t* out, uint32_t isize) {
  if (isize == 0) return 0;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return -1;
  zs.next_in = const_cast<uint8_t*>(cdata);
  zs.avail_in = (uInt)clen;
  zs.next_out = out;
  zs.avail_out = (uInt)isize;
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return ret == Z_STREAM_END ? 0 : -1;
}
}  // namespace

int64_t ltr_bgzf_inflate_mt(const uint8_t* src, int64_t n,
                            uint8_t* dst, int64_t dst_cap, int nthreads) {
  std::vector<BgzfBlock> blocks;
  int64_t off = 0, out = 0;
  while (off + 18 <= n) {
    if (src[off] != 0x1f || src[off + 1] != 0x8b) return -1;
    uint16_t xlen = src[off + 10] | (src[off + 11] << 8);
    int64_t xoff = off + 12;
    int64_t xend = xoff + xlen;
    if (xend > n) { if (off == 0) return -1; break; }
    int32_t bsize = -1;
    while (xoff + 4 <= xend) {
      uint8_t si1 = src[xoff], si2 = src[xoff + 1];
      uint16_t slen = src[xoff + 2] | (src[xoff + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        bsize = (src[xoff + 4] | (src[xoff + 5] << 8)) + 1;
        break;
      }
      xoff += 4 + slen;
    }
    if (bsize < 18 || bsize < 12 + (int32_t)xlen + 8) return -1;
    if (off + bsize > n) break;
    uint32_t isize;
    memcpy(&isize, src + off + bsize - 4, 4);
    if (out + isize > dst_cap) return -2;
    blocks.push_back({off + 12 + xlen, bsize - 12 - xlen - 8, out, isize});
    out += isize;
    off += bsize;
  }
  if (nthreads < 1) nthreads = 1;
  if ((int64_t)blocks.size() < 2 * nthreads) nthreads = 1;
  if (nthreads == 1) {
    for (const BgzfBlock& b : blocks)
      if (inflate_one(src + b.coff, b.clen, dst + b.doff, b.isize) != 0)
        return -1;
    return out;
  }
  std::vector<std::thread> pool;
  std::vector<int> errs(nthreads, 0);
  for (int t = 0; t < nthreads; t++) {
    pool.emplace_back([&, t]() {
      for (size_t i = t; i < blocks.size(); i += nthreads) {
        const BgzfBlock& b = blocks[i];
        if (inflate_one(src + b.coff, b.clen, dst + b.doff, b.isize) != 0) {
          errs[t] = 1;
          return;
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  for (int e : errs) if (e) return -1;
  return out;
}

// ---------------------------------------------------------------------------
// BAM record scan/decode
// ---------------------------------------------------------------------------

static const char SEQ_NT16[17] = "=ACMGRSVTWYHKDBN";
static const char CIGAR_OPS[10] = "MIDNSHP=X";

// Count BAM records in an uncompressed buffer starting at a record boundary.
int64_t ltr_bam_count_records(const uint8_t* buf, int64_t n) {
  int64_t off = 0, count = 0;
  while (off + 4 <= n) {
    int32_t block_size;
    memcpy(&block_size, buf + off, 4);
    if (block_size < 32 || off + 4 + block_size > n) break;
    count++;
    off += 4 + block_size;
  }
  return count;
}

// Decode up to max_records records into columnar arrays.
//
// Fixed-width outputs (length max_records):
//   ref_id, pos, mapq, flag, mate_ref, mate_pos, tlen, l_seq : int32
//   name_off/name_len, cigar_off/cigar_n, seq_off, qual_off,
//   tag_off/tag_len, rec_end : int64 offsets into the respective pools
// Pools:
//   names: concatenated NUL-free name bytes
//   cigar_ops: uint8 op chars; cigar_lens: int32 lengths
//   seqs: ASCII bases; quals: phred+33 bytes (same offsets as seqs)
// Returns number of records decoded, or -1 on error.
int64_t ltr_bam_decode(const uint8_t* buf, int64_t n, int64_t max_records,
                       int32_t* fixed,          // (max_records, 8) int32
                       int64_t* offsets,        // (max_records, 8) int64
                       uint8_t* names, int64_t names_cap,
                       uint8_t* cigar_ops, int32_t* cigar_lens, int64_t cigar_cap,
                       uint8_t* seqs, uint8_t* quals, int64_t seq_cap,
                       uint8_t* tags, int64_t tags_cap,
                       int32_t* ref_lens) {
  int64_t off = 0, rec = 0;
  int64_t name_out = 0, cig_out = 0, seq_out = 0, tag_out = 0;
  while (off + 4 <= n && rec < max_records) {
    int32_t block_size;
    memcpy(&block_size, buf + off, 4);
    if (block_size < 32 || off + 4 + block_size > n) break;
    const uint8_t* r = buf + off + 4;

    int32_t ref_id, pos, l_seq, next_ref, next_pos, tlen;
    memcpy(&ref_id, r, 4);
    memcpy(&pos, r + 4, 4);
    uint8_t l_read_name = r[8];
    uint8_t mapq = r[9];
    uint16_t n_cigar, flag;
    memcpy(&n_cigar, r + 12, 2);
    memcpy(&flag, r + 14, 2);
    memcpy(&l_seq, r + 16, 4);
    memcpy(&next_ref, r + 20, 4);
    memcpy(&next_pos, r + 24, 4);
    memcpy(&tlen, r + 28, 4);

    // Per-record sanity: a corrupt block must produce a clean error, not an
    // out-of-bounds read/write (l_read_name==0 would underflow the name
    // copy; negative l_seq would walk p backwards; oversized counts would
    // read past the record).
    if (l_read_name < 1 || l_seq < 0) return -1;
    int64_t need = 32 + (int64_t)l_read_name + 4 * (int64_t)n_cigar +
                   ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq;
    if (need > (int64_t)block_size) return -1;

    int32_t* f = fixed + rec * 8;
    f[0] = ref_id; f[1] = pos; f[2] = mapq; f[3] = flag;
    f[4] = next_ref; f[5] = next_pos; f[6] = tlen; f[7] = l_seq;

    int64_t* o = offsets + rec * 8;
    const uint8_t* p = r + 32;

    // name
    if (name_out + l_read_name > names_cap) return -2;
    memcpy(names + name_out, p, l_read_name - 1);
    o[0] = name_out; o[1] = l_read_name - 1;
    name_out += l_read_name - 1;
    p += l_read_name;

    // cigar
    if (cig_out + n_cigar > cigar_cap) return -2;
    o[2] = cig_out; o[3] = n_cigar;
    int64_t span = 0;
    for (int k = 0; k < n_cigar; ++k) {
      uint32_t v;
      memcpy(&v, p + 4 * k, 4);
      uint8_t opc = (uint8_t)CIGAR_OPS[v & 0xF];
      cigar_ops[cig_out + k] = opc;
      cigar_lens[cig_out + k] = (int32_t)(v >> 4);
      // reference-consuming ops: M, D, N, =, X
      if (opc == 'M' || opc == 'D' || opc == 'N' || opc == '=' || opc == 'X')
        span += (int64_t)(v >> 4);
    }
    ref_lens[rec] = (int32_t)span;
    cig_out += n_cigar;
    p += 4 * (int64_t)n_cigar;

    // seq (4-bit packed) + qual
    if (seq_out + l_seq > seq_cap) return -2;
    o[4] = seq_out;
    for (int k = 0; k < l_seq; ++k) {
      uint8_t b = p[k >> 1];
      uint8_t code = (k & 1) ? (b & 0xF) : (b >> 4);
      seqs[seq_out + k] = (uint8_t)SEQ_NT16[code];
    }
    p += (l_seq + 1) / 2;
    for (int k = 0; k < l_seq; ++k) {
      int q = p[k] + 33;
      quals[seq_out + k] = (uint8_t)(q > 126 ? 126 : q);
    }
    o[5] = seq_out;
    seq_out += l_seq;
    p += l_seq;

    // tags: raw blob
    const uint8_t* rec_end = r + block_size;
    int64_t tag_len = rec_end - p;
    if (tag_len < 0) return -1;
    if (tag_out + tag_len > tags_cap) return -2;
    memcpy(tags + tag_out, p, tag_len);
    o[6] = tag_out; o[7] = tag_len;
    tag_out += tag_len;

    off += 4 + block_size;
    rec++;
  }
  return rec;
}

// ---------------------------------------------------------------------------
// rANS 4x8 decode (CRAM block compression method 4).  Mirrors the Python
// implementation in longtr_tpu/io/rans.py; spec: CRAM 3.0 section 13.
// Returns 0 on success, negative on malformed input.

namespace {

constexpr uint32_t kRansL = 1u << 23;
constexpr uint32_t kTotFreq = 1u << 12;

struct FreqTable {
  uint32_t freq[256];
  uint32_t cum[257];
  uint8_t lut[kTotFreq];
  // Frequencies must sum to exactly kTotFreq (4096, CRAM 3.0 §13); a
  // malformed table would otherwise overflow lut[] below.  Returns false
  // on a bad table so callers can reject the block.
  bool finish() {
    cum[0] = 0;
    for (int i = 0; i < 256; i++) {
      if (freq[i] > kTotFreq) return false;
      cum[i + 1] = cum[i] + freq[i];
      if (cum[i + 1] > kTotFreq) return false;
    }
    if (cum[256] != kTotFreq) return false;
    for (int s = 0; s < 256; s++)
      for (uint32_t k = 0; k < freq[s]; k++) lut[cum[s] + k] = (uint8_t)s;
    return true;
  }
};

// Order-0 frequency table parse; returns new position or -1.
long read_freqs_o0(const uint8_t* d, long pos, long n, FreqTable* t) {
  for (int i = 0; i < 256; i++) t->freq[i] = 0;
  int rle = 0, last = -2;
  if (pos >= n) return -1;
  int sym = d[pos++];
  for (;;) {
    int cur;
    if (rle) {
      rle--;
      cur = last + 1;
    } else {
      cur = sym;
      if (cur == last + 1) {
        if (pos >= n) return -1;
        rle = d[pos++];
      }
    }
    if (pos >= n) return -1;
    uint32_t f = d[pos++];
    if (f & 0x80) {
      if (pos >= n) return -1;
      f = ((f & 0x7F) << 8) | d[pos++];
    }
    if (cur < 0 || cur > 255) return -1;
    t->freq[cur] = f;
    last = cur;
    if (rle) continue;
    if (pos >= n) return -1;
    sym = d[pos++];
    if (sym == 0) break;
  }
  if (!t->finish()) return -1;
  return pos;
}

inline void renorm(uint32_t* x, const uint8_t* d, long* pos, long n) {
  while (*x < kRansL && *pos < n) *x = (*x << 8) | d[(*pos)++];
}

}  // namespace

extern "C" int ltr_rans_decode(const uint8_t* data, long n,
                               uint8_t* out, long out_sz) {
  if (n < 9) return -1;
  int order = data[0];
  long pos = 9;
  if (out_sz == 0) return 0;
  if (order == 0) {
    FreqTable t;
    pos = read_freqs_o0(data, pos, n, &t);
    if (pos < 0) return -2;
    uint32_t states[4];
    for (int j = 0; j < 4; j++) {
      if (pos + 4 > n) return -3;
      states[j] = (uint32_t)data[pos] | ((uint32_t)data[pos + 1] << 8) |
                  ((uint32_t)data[pos + 2] << 16) |
                  ((uint32_t)data[pos + 3] << 24);
      pos += 4;
    }
    for (long i = 0; i < out_sz; i++) {
      int j = i & 3;
      uint32_t x = states[j];
      uint32_t slot = x & (kTotFreq - 1);
      uint8_t s = t.lut[slot];
      out[i] = s;
      x = t.freq[s] * (x >> 12) + slot - t.cum[s];
      renorm(&x, data, &pos, n);
      states[j] = x;
    }
    return 0;
  }
  if (order != 1) return -4;
  // order-1: per-context tables
  static thread_local FreqTable* tabs = nullptr;
  if (!tabs) tabs = new FreqTable[256];
  bool present[256] = {false};
  {
    int rle = 0, last = -2;
    if (pos >= n) return -1;
    int sym = data[pos++];
    for (;;) {
      int cur;
      if (rle) {
        rle--;
        cur = last + 1;
      } else {
        cur = sym;
        if (cur == last + 1) {
          if (pos >= n) return -1;
          rle = data[pos++];
        }
      }
      if (cur < 0 || cur > 255) return -1;
      pos = read_freqs_o0(data, pos, n, &tabs[cur]);
      if (pos < 0) return -2;
      present[cur] = true;
      last = cur;
      if (rle) continue;
      if (pos >= n) return -1;
      sym = data[pos++];
      if (sym == 0) break;
    }
  }
  uint32_t states[4];
  for (int j = 0; j < 4; j++) {
    if (pos + 4 > n) return -3;
    states[j] = (uint32_t)data[pos] | ((uint32_t)data[pos + 1] << 8) |
                ((uint32_t)data[pos + 2] << 16) |
                ((uint32_t)data[pos + 3] << 24);
    pos += 4;
  }
  long isz4 = out_sz >> 2;
  long starts[4] = {0, isz4, 2 * isz4, 3 * isz4};
  int last_sym[4] = {0, 0, 0, 0};
  for (long step = 0; step < isz4; step++) {
    for (int j = 0; j < 4; j++) {
      int ctx = last_sym[j];
      if (!present[ctx]) return -5;
      FreqTable& t = tabs[ctx];
      uint32_t x = states[j];
      uint32_t slot = x & (kTotFreq - 1);
      uint8_t s = t.lut[slot];
      out[starts[j] + step] = s;
      last_sym[j] = s;
      x = t.freq[s] * (x >> 12) + slot - t.cum[s];
      renorm(&x, data, &pos, n);
      states[j] = x;
    }
  }
  for (long i = starts[3] + isz4; i < out_sz; i++) {
    int ctx = last_sym[3];
    if (!present[ctx]) return -5;
    FreqTable& t = tabs[ctx];
    uint32_t x = states[3];
    uint32_t slot = x & (kTotFreq - 1);
    uint8_t s = t.lut[slot];
    out[i] = s;
    last_sym[3] = s;
    x = t.freq[s] * (x >> 12) + slot - t.cum[s];
    renorm(&x, data, &pos, n);
    states[3] = x;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// POA consensus (spoa-equivalent; mirrors longtr_tpu/haplotype/poa.py
// node-for-node including tie-break order, so Python and native paths give
// identical consensus strings).

#include <vector>
#include <string>
#include <algorithm>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace poa {

constexpr int MATCH = 1, MISMATCH = -1, GAP = -1;
constexpr long NEG = -1000000000L;

// In-place prefix max.  The scalar form is a loop-carried dependence
// (~2.5 cycles/element) and dominates the POA row cost once the value
// passes vectorize, so the int16 overload does the classic SIMD scan:
// log-step shift-max within each 128-bit lane, one cross-lane fix, and
// a 16-element-granular running carry.  max is associative and these
// are exact integer ops, so the result is identical to the scalar scan.
template <typename S>
static inline void prefix_max_inplace(S* a, size_t n) {
  S rm = a[0];
  for (size_t j = 1; j < n; j++) { if (a[j] > rm) rm = a[j]; a[j] = rm; }
}

#if defined(__AVX2__)
static inline void prefix_max_inplace(int16_t* a, size_t n) {
  const __m256i minv = _mm256_set1_epi16(INT16_MIN);
  // byte-shuffle pattern replicating each 128-bit lane's element 7
  const __m256i b7idx = _mm256_set_epi8(
      15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14,
      15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14, 15, 14);
  __m256i carry = minv;
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(a + i));
    // per-lane prefix max (shift-in INT16_MIN, the max identity)
    v = _mm256_max_epi16(v, _mm256_alignr_epi8(v, minv, 14));
    v = _mm256_max_epi16(v, _mm256_alignr_epi8(v, minv, 12));
    v = _mm256_max_epi16(v, _mm256_alignr_epi8(v, minv, 8));
    // cross-lane: fold the low lane's element 7 into the high lane only
    __m256i low = _mm256_permute2x128_si256(v, v, 0x00);
    __m256i b7 = _mm256_shuffle_epi8(low, b7idx);
    v = _mm256_max_epi16(v, _mm256_blend_epi32(minv, b7, 0xF0));
    v = _mm256_max_epi16(v, carry);
    _mm256_storeu_si256((__m256i*)(a + i), v);
    __m256i hi = _mm256_permute2x128_si256(v, v, 0x11);
    carry = _mm256_shuffle_epi8(hi, b7idx);
  }
  size_t j = i;
  int16_t rm;
  if (i == 0) { rm = a[0]; j = 1; }
  else rm = (int16_t)_mm256_extract_epi16(carry, 0);
  for (; j < n; j++) { if (a[j] > rm) rm = a[j]; a[j] = rm; }
}
#endif

struct Graph {
  std::vector<char> ch;
  // insertion-ordered adjacency (Python dict semantics)
  std::vector<std::vector<std::pair<int,int>>> out_e, in_e;
  std::vector<std::vector<int>> aligned_to;

  int new_node(char c) {
    ch.push_back(c);
    out_e.emplace_back();
    in_e.emplace_back();
    aligned_to.emplace_back();
    return (int)ch.size() - 1;
  }
  static int find(std::vector<std::pair<int,int>>& v, int key) {
    for (size_t i = 0; i < v.size(); i++) if (v[i].first == key) return (int)i;
    return -1;
  }
  void add_edge(int a, int b, int w) {
    int i = find(out_e[a], b);
    if (i < 0) out_e[a].push_back({b, w}); else out_e[a][i].second += w;
    i = find(in_e[b], a);
    if (i < 0) in_e[b].push_back({a, w}); else in_e[b][i].second += w;
  }

  std::vector<int> topo() const {
    int n = (int)ch.size();
    std::vector<int> indeg(n), order;
    order.reserve(n);
    std::vector<int> stack;
    for (int i = 0; i < n; i++) indeg[i] = (int)in_e[i].size();
    for (int i = 0; i < n; i++) if (!indeg[i]) stack.push_back(i);
    while (!stack.empty()) {
      int v = stack.back(); stack.pop_back();
      order.push_back(v);
      for (auto& e : out_e[v])
        if (--indeg[e.first] == 0) stack.push_back(e.first);
    }
    return order;
  }

  void add_sequence(const char* seq, int m) {
    if (m == 0) return;
    if (ch.empty()) {
      int prev = -1;
      for (int j = 0; j < m; j++) {
        int v = new_node(seq[j]);
        if (prev >= 0) add_edge(prev, v, 1);
        prev = v;
      }
      return;
    }
    std::vector<int> aln(m, -1);
    align(seq, m, aln);
    fuse(seq, m, aln);
  }

  // scratch reused across add_sequence calls (large loci would otherwise
  // reallocate + fault ~100MB of DP per aligned read)
  std::vector<int32_t> dp_, bt_node_;
  std::vector<signed char> bt_type_;
  std::vector<int32_t> row_pred_, pmax_;
  std::vector<int16_t> dp16_, pmax16_;
  long last_B_ = 0;  // band memory: 0 unknown, >0 last accepted, -1 unbanded

  void align(const char* seq, int m, std::vector<int>& aln) {
    // Exact int16 fast path: unit-cost scores are bounded by ±(nodes+m).
    // The tight invariant is dp[i][j] <= min(i, j) (matches are bounded by
    // both consumed columns and the path length through the graph), so
    // pmax[j] = dst[j] + j <= nodes + m; while nodes+m stays well inside
    // the int16 range the narrow DP computes
    // bit-identical values with half the memory traffic and double the
    // SIMD width; the -30000 sentinel is below any reachable score.
    // This DP is DRAM/issue-bound, so the narrowing is a real win at
    // the multi-kb VNTR scale the rescue path feeds it.
    //
    // Banded attempts with an exactness PROOF (scores (1, -1, -1)).  A
    // path reaching node v has consumed len nodes with mind(v) <= len <=
    // maxd(v) (shortest/longest source->v path; topo index is NOT a valid
    // proxy — ring/bubble alternates get arbitrary topo positions), and
    // |len - j| <= #gap-steps.  Restricting row v to j in
    // [mind(v) - B, maxd(v) + B] therefore loses only paths with > B
    // gaps, whose score is <= m - B - 1 (score = matches - mismatches -
    // gaps <= m - gaps).  So if the banded best score s satisfies
    // s >= m - B, every optimal-scoring path — including every tie the
    // traceback's fixed preference rules could choose — lies strictly
    // inside the windows; the DP values and bt decisions at every cell
    // the traceback visits equal the unbanded ones, and the banded
    // result is BIT-IDENTICAL to the full DP (the differential
    // native/Python consensus fuzz stays valid unchanged).  If
    // verification fails, retry wider, finally unbanded.  Cluster
    // members differ from the graph by sequencing errors plus
    // allele-length skew, so the first band almost always verifies.
    long diff = (long)ch.size() >= (long)m ? (long)ch.size() - m
                                           : (long)m - (long)ch.size();
    bool b16 = (long)ch.size() + m + 2 < 28000;
    static const bool no_band = getenv("LONGTR_POA_NO_BAND") != nullptr;
    static const bool dbg = getenv("LONGTR_POA_DEBUG") != nullptr;
    // per-graph band memory: cluster members are homogeneous, so the
    // band (or the unbanded verdict, last_B_ < 0) discovered on one read
    // almost always fits the next — failed ladder rungs then cost one
    // read's discovery per cluster instead of repeating on every read
    long start_B = 64 + diff;
    if (last_B_ > start_B) start_B = last_B_;
    if (last_B_ >= 0 && !no_band) {
      bool attempted = false;
      for (long B = start_B; 2 * B + 1 < m; B = 4 * B + 64) {
        attempted = true;
        bool ok = b16
            ? align_impl<int16_t>(seq, m, aln, dp16_, pmax16_, B)
            : align_impl<int32_t>(seq, m, aln, dp_, pmax_, B);
        if (dbg)
          fprintf(stderr, "[poa] m=%d nodes=%zu B=%ld ok=%d\n", m,
                  ch.size(), B, (int)ok);
        if (ok) {
          last_B_ = B;
          return;
        }
      }
      // only a banded attempt that RAN and failed verification is an
      // unbanded verdict for the cluster; a ladder whose first rung
      // already exceeded this read's m (large |nodes-m| skew, short
      // read) says nothing about the next read's bandability
      if (attempted) last_B_ = -1;
    }
    if (dbg) fprintf(stderr, "[poa] m=%d nodes=%zu UNBANDED\n", m, ch.size());
    if (b16)
      align_impl<int16_t>(seq, m, aln, dp16_, pmax16_, -1);
    else
      align_impl<int32_t>(seq, m, aln, dp_, pmax_, -1);
  }

  // band < 0: full DP (always succeeds).  band >= 0: rows restricted to
  // j in [i - band, i + band]; returns false (aln untouched) unless the
  // best sink score proves global optimality (see align()).
  template <typename S>
  bool align_impl(const char* seq, int m, std::vector<int>& aln,
                  std::vector<S>& dp, std::vector<S>& pmax_vec,
                  long band) {
    const S NEG_S = (S)(sizeof(S) == 2 ? -30000L : NEG);
    std::vector<int> order = topo();
    int n = (int)order.size();
    std::vector<int> pos_in_order(ch.size());
    for (int i = 0; i < n; i++) pos_in_order[order[i]] = i;
    // shortest/longest #nodes consumed on any source->row path (row 0 =
    // the virtual start row); band windows anchor on these — NOT on the
    // topo index, which ring/bubble alternates displace arbitrarily
    std::vector<int> mind, maxd;
    if (band >= 0) {
      mind.assign(n + 1, 0);
      maxd.assign(n + 1, 0);
      for (int i = 1; i <= n; i++) {
        int v = order[i - 1];
        if (in_e[v].empty()) {
          mind[i] = maxd[i] = 1;
          continue;
        }
        int lo = 1 << 30, hi = 0;
        for (auto& e : in_e[v]) {
          int p = pos_in_order[e.first] + 1;
          if (mind[p] < lo) lo = mind[p];
          if (maxd[p] > hi) hi = maxd[p];
        }
        mind[i] = lo + 1;
        maxd[i] = hi + 1;
      }
      // a banded pass only pays off when the windows are actually
      // narrow; indel-heavy graphs accumulate mind/maxd skew (every
      // insertion branch widens downstream windows), and running a
      // near-full-width "band" just adds window bookkeeping on top of
      // the full DP.  Bail out cheaply and let align() fall through to
      // the unbanded pass.
      long area = 0;
      for (int i = 1; i <= n; i++) {
        long lo = (long)mind[i] - band > 0 ? (long)mind[i] - band : 0;
        long hi = (long)maxd[i] + band < (long)m ? (long)maxd[i] + band
                                                 : (long)m;
        area += hi - lo + 1;
      }
      if (area * 2 >= (long)n * (long)(m + 1))
        return false;
    }
    // traceback rows are stored at WINDOW width, not full width: the
    // (n+1) x (m+1) bt matrices were the dominant memory traffic of a
    // banded align (tens of MB of allocation + page faults per read
    // while the windowed DP itself touches only ~n*band cells)
    size_t wmax = (size_t)m + 1;
    if (band >= 0) {
      wmax = 1;
      for (int i = 1; i <= n; i++) {
        long lo = (long)mind[i] - band > 0 ? (long)mind[i] - band : 0;
        long hi = (long)maxd[i] + band < (long)m ? (long)maxd[i] + band
                                                 : (long)m;
        if ((size_t)(hi - lo + 1) > wmax) wmax = (size_t)(hi - lo + 1);
      }
    }
    std::vector<int> row_jlo(n + 1, 0);
    size_t W = (size_t)m + 1;
    // narrow DP: unit scores bounded by +-(n+m), identical results to
    // wider types whenever they fit (the dispatcher guarantees it)
    std::vector<int32_t>& bt_node = bt_node_;
    std::vector<signed char>& bt_type = bt_type_;
    // Live-row slot pool: traceback reads bt_type/bt_node only (never dp),
    // and a dp row is dead once its last successor row is filled, so only
    // the live rows are kept (a handful on the near-linear graphs POA
    // builds: a ~n*W dp matrix would stream ~100MB/read through DRAM,
    // and this DP is DRAM-bound).  endcol keeps each row's dp[i][m] for
    // the sink scan.  bt_node is only WRITTEN on multi-predecessor rows
    // (row_pred_ holds the row-constant predecessor otherwise).
    size_t need = (size_t)(n + 1) * wmax;
    if (bt_node.size() < need) {
      bt_node.resize(need);
      bt_type.resize(need);
    }
    if (row_pred_.size() < (size_t)(n + 1)) row_pred_.resize(n + 1);
    if (pmax_vec.size() < W) pmax_vec.resize(W);
    // last_use[r]: last topo row that reads dp row r (itself if none).
    std::vector<int> last_use(n + 1);
    for (int r = 0; r <= n; r++) last_use[r] = r;
    for (int i = 1; i <= n; i++) {
      int v = order[i - 1];
      if (in_e[v].empty()) {
        last_use[0] = i;
      } else {
        for (auto& e : in_e[v]) {
          int p = pos_in_order[e.first] + 1;
          if (last_use[p] < i) last_use[p] = i;
        }
      }
    }
    // rows whose slot frees after step i (linked lists over rows)
    std::vector<int> end_head(n + 1, -1), end_next(n + 1, -1);
    int max_live = 0;
    {
      int live = 0;
      std::vector<int> ends(n + 2, 0);
      for (int r = 0; r <= n; r++) ends[last_use[r] + 1]++;
      for (int r = 0; r <= n; r++) {
        live += 1 - ends[r];            // alloc row r; free rows ending at r-1
        if (live > max_live) max_live = live;
      }
      for (int r = n; r >= 0; r--) {    // head-insert keeps ascending order
        end_next[r] = end_head[last_use[r]];
        end_head[last_use[r]] = r;
      }
    }
    if (dp.size() < (size_t)max_live * W) dp.resize((size_t)max_live * W);
    std::vector<int> slot_of(n + 1, -1), free_slots;
    // Banded discipline: a slot only ever holds its row's window
    // [slot_lo, slot_hi]; READERS clip against the producer's recorded
    // window instead of relying on sentinel fills (fills cost
    // max_live * W writes, which explodes on ring-heavy graphs whose
    // long row lifetimes inflate the pool).  Out-of-window reads are
    // treated as NEG_S by segmenting the consumer loops.
    std::vector<long> slot_lo(max_live, 0), slot_hi(max_live, -1);
    int n_slots = 0;
    auto alloc_slot = [&](long jlo, long jhi) {
      int s;
      if (!free_slots.empty()) {
        s = free_slots.back();
        free_slots.pop_back();
      } else {
        s = n_slots++;
      }
      slot_lo[s] = jlo;
      slot_hi[s] = jhi;
      return s;
    };
    auto free_after = [&](int i) {
      for (int r = end_head[i]; r >= 0; r = end_next[r])
        free_slots.push_back(slot_of[r]);
    };
    slot_of[0] = alloc_slot(0, m);  // boundary row: exact over all columns
    {
      S* r0 = &dp[(size_t)slot_of[0] * W];
      for (int j = 0; j <= m; j++) r0[j] = (S)(j * GAP);
    }
    std::vector<int32_t> endcol(n + 1);
    endcol[0] = (int32_t)(m * GAP);
    free_after(0);
    std::vector<S> best_up(W);
    std::vector<int32_t> best_up_p(W);
    S* __restrict__ pmax = pmax_vec.data();
    for (int i = 1; i <= n; i++) {
      int v = order[i - 1];
      // band window for this row ([0, m] when unbanded)
      long jlo = band < 0 ? 0
          : ((long)mind[i] - band > 0 ? (long)mind[i] - band : 0);
      long jhi = band < 0 ? (long)m
          : ((long)maxd[i] + band < (long)m ? (long)maxd[i] + band
                                            : (long)m);
      long jfrom = jlo > 0 ? jlo - 1 : 0;  // value loop reads up[jlo - 1]
      // predecessor rows (insertion order; first strict improvement wins).
      // best_diag[j] == best_up[j] for j < W-1 under strict-improvement
      // scanning in the same predecessor order, so one row serves both.
      bool any_pred = !in_e[v].empty();
      const S* up;
      int up_p = -2;  // >= -1: all predecessors are this single row id
      if (!any_pred) {
        up = &dp[(size_t)slot_of[0] * W];
        up_p = 0;
      } else if (in_e[v].size() == 1) {
        // single predecessor (the common case): alias its row, no copy
        up_p = pos_in_order[in_e[v][0].first] + 1;
        up = &dp[(size_t)slot_of[up_p] * W];
      } else {
        for (long j = jfrom; j <= jhi; j++) {
          best_up[j] = NEG_S;
          best_up_p[j] = -1;
        }
        for (auto& e : in_e[v]) {
          int p = pos_in_order[e.first] + 1;
          const S* d = &dp[(size_t)slot_of[p] * W];
          // clip to the predecessor's recorded window: cells outside it
          // hold a previous tenant's garbage, and band semantics treat
          // them as -inf anyway
          long glo = jfrom > slot_lo[slot_of[p]] ? jfrom
                                                 : slot_lo[slot_of[p]];
          long ghi = jhi < slot_hi[slot_of[p]] ? jhi
                                               : slot_hi[slot_of[p]];
          for (long j = glo; j <= ghi; j++)
            if (d[j] > best_up[j]) { best_up[j] = d[j]; best_up_p[j] = p; }
        }
        up = best_up.data();
      }
      row_pred_[i] = up_p;
      slot_of[i] = alloc_slot(jlo, jhi);
      char base = ch[v];
      // __restrict__: rows/arrays never overlap (dst is row i's fresh
      // slot; up is a live earlier row's slot or the best_up scratch) —
      // lets the compiler vectorize without alias-version checks
      S* __restrict__ dst = &dp[(size_t)slot_of[i] * W];
      row_jlo[i] = (int)jlo;
      // windowed traceback rows: bt[j]/bn[j] index with the row's jlo
      // offset folded into the base pointer (valid for j in the window)
      int32_t* __restrict__ bn = &bt_node[(size_t)i * wmax] - jlo;
      signed char* __restrict__ bt = &bt_type[(size_t)i * wmax] - jlo;
      const S* __restrict__ upr = up;
      const int32_t* __restrict__ bup = best_up_p.data();
      const char* __restrict__ sq = seq;
      // columns where upr holds DEFINED values: the producer row's
      // recorded window (the best_up scratch is defined over the full
      // [jfrom, jhi] it was just filled on).  Reads outside [plo, phi]
      // are band-semantics -inf and the consumer loop is segmented so
      // the hot interior runs with no per-element clipping.
      long plo, phi;
      if (up_p == -2) {
        plo = jfrom;
        phi = jhi;
      } else {
        plo = slot_lo[slot_of[up_p]];
        phi = slot_hi[slot_of[up_p]];
      }
      // fused pass: up, then strictly-better diag (same result order as
      // separate passes); the left-gap pass follows in closed form
      if (jlo == 0) {
        S v0 = plo == 0 ? (S)(upr[0] + GAP) : NEG_S;
        if (v0 < NEG_S) v0 = NEG_S;
        dst[0] = v0;
        bt[0] = 1;
      }
      long j1 = jlo > 1 ? jlo : 1;
      // left sentinel prefix: both up and diag sources undefined
      for (long j = j1; j <= jhi && j < plo; j++) {
        dst[j] = NEG_S;
        bt[j] = 1;
      }
      // boundary j == plo: up source defined, diag source (plo-1) not
      if (plo >= j1 && plo <= jhi) {
        S val = (S)(upr[plo] + GAP);
        if (val < NEG_S) val = NEG_S;
        dst[plo] = val;
        bt[plo] = 1;
      }
      long hot_lo = j1 > plo + 1 ? j1 : plo + 1;
      long hot_hi = jhi < phi ? jhi : phi;
      if (up_p >= -1) {
        for (long j = hot_lo; j <= hot_hi; j++) {
          S val = (S)(upr[j] + GAP);
          signed char t = 1;
          S diag = (S)(upr[j - 1] +
                       ((sq[j - 1] == base) ? MATCH : MISMATCH));
          if (diag > val) { val = diag; t = 0; }
          // sentinel floor: real cells are always > NEG_S (bounded by
          // -(i+j) > -28000), so this is a no-op for them; it stops
          // banded sentinel-VALUED cells from sinking below NEG_S, which
          // would underflow the int16 pmax arithmetic below
          if (val < NEG_S) val = NEG_S;
          dst[j] = val; bt[j] = t;
        }
      } else {
        // split into a value pass (identical to the single-pred loop, so
        // it vectorizes — the fused variant tripped gcc's alias-check
        // budget with 6 live pointers) and a tiny bn gather keyed on bt
        for (long j = hot_lo; j <= hot_hi; j++) {
          S val = (S)(upr[j] + GAP);
          signed char t = 1;
          S diag = (S)(upr[j - 1] +
                       ((sq[j - 1] == base) ? MATCH : MISMATCH));
          if (diag > val) { val = diag; t = 0; }
          if (val < NEG_S) val = NEG_S;
          dst[j] = val; bt[j] = t;
        }
      }
      // boundary j == phi + 1: up source undefined, diag source defined
      if (phi + 1 >= j1 && phi + 1 <= jhi) {
        long j = phi + 1;
        S val = NEG_S;
        signed char t = 1;
        S diag = (S)(upr[j - 1] +
                     ((sq[j - 1] == base) ? MATCH : MISMATCH));
        if (diag > val) { val = diag; t = 0; }
        if (val < NEG_S) val = NEG_S;
        dst[j] = val; bt[j] = t;
      }
      // right sentinel tail: both sources undefined
      for (long j = (phi + 2 > j1 ? phi + 2 : j1); j <= jhi; j++) {
        dst[j] = NEG_S;
        bt[j] = 1;
      }
      if (up_p == -2) {
        if (jlo == 0) bn[0] = bup[0];
        for (long j = j1; j <= jhi; j++)
          bn[j] = bup[j - (bt[j] == 0)];
      }
      // left-gap pass in closed form: the cascade
      //   dst[j] = max(dst[j], dst[j-1] + GAP)   (updated dst[j-1])
      // equals dst'[j] = max_{k<=j}(dst[k] + (j-k)*GAP); with GAP = -1
      // that is (prefix-max of dst[k] + k) - j, exact in integers.
      // Including dst[j] + j itself in the prefix max is harmless: it
      // makes nd >= dst[j], and the strict > excludes the self case, so
      // bt updates exactly when the original cascade updated.  Two
      // passes, not one: the scalar prefix scan stays minimal and the
      // compare/update pass vectorizes (measured ~1.6x over the fused
      // scalar loop).  (t==2 traceback only decrements j, so bn is
      // never read there.)
      static_assert(GAP == -1, "closed-form left pass assumes GAP == -1");
      if (jlo <= jhi) {
        // banded: the cascade cannot enter from outside the window (those
        // cells are NEG_S sentinels), so the prefix max runs window-only
        for (long j = jlo; j <= jhi; j++) pmax[j] = (S)(dst[j] + (S)j);
        prefix_max_inplace(pmax + jlo, (size_t)(jhi - jlo + 1));
        for (long j = j1; j <= jhi; j++) {
          // widen before subtracting: sentinel-region pmax minus a large
          // j would underflow int16; the clamp keeps sentinel semantics
          long ndw = (long)pmax[j] - j;
          S nd = ndw < (long)NEG_S ? NEG_S : (S)ndw;
          if (nd > dst[j]) { dst[j] = nd; bt[j] = 2; }
        }
      }
      endcol[i] = (jlo <= jhi && jhi == (long)m) ? (int32_t)dst[m]
                                                 : (int32_t)NEG;
      free_after(i);
    }
    // endpoint: best sink (max over sinks of dp[i][m]; first max wins to
    // mirror Python's max() over the sink list in node order)
    int best_i = -1;
    long best_v = NEG - 1;
    bool any_sink = false;
    for (size_t v2 = 0; v2 < ch.size(); v2++) {
      if (out_e[v2].empty()) {
        any_sink = true;
        int i2 = pos_in_order[v2] + 1;
        if (endcol[i2] > best_v) { best_v = endcol[i2]; best_i = i2; }
      }
    }
    if (!any_sink) {
      for (int i2 = 0; i2 <= n; i2++)
        if (endcol[i2] > best_v) { best_v = endcol[i2]; best_i = i2; }
    }
    // banded exactness verification (see align()): any path exiting the
    // band scores <= m - band - 1, so best_v >= m - band proves the full
    // DP would find the same score AND the same tie-broken traceback.
    if (band >= 0 && best_v < (long)m - band)
      return false;
    int i = best_i, j = m;
    while (i != 0 || j != 0) {
      if (i == 0) { j--; continue; }
      signed char t = bt_type[(size_t)i * wmax + (j - row_jlo[i])];
      if (t == 2) { j--; continue; }
      // predecessor row: row-constant unless this row had multiple
      // predecessors (row_pred_ == -2), in which case bt_node holds it
      int pred = row_pred_[i] >= -1 ? row_pred_[i]
                                    : bt_node[(size_t)i * wmax
                                               + (j - row_jlo[i])];
      if (t == 0) { aln[j - 1] = order[i - 1]; i = pred; j--; }
      else { i = pred; }
    }
    return true;
  }

  void fuse(const char* seq, int m, const std::vector<int>& aln) {
    int prev = -1;
    for (int j = 0; j < m; j++) {
      char c = seq[j];
      int node = aln[j];
      int target = -1;
      if (node >= 0) {
        if (ch[node] == c) target = node;
        else {
          for (int alt : aligned_to[node])
            if (ch[alt] == c) { target = alt; break; }
          if (target < 0) {
            target = new_node(c);
            // ring = [node] + aligned_to[node]; register the new node
            // with EVERY ring member (mirrors poa.py _fuse)
            std::vector<int> ring;
            ring.push_back(node);
            for (int x : aligned_to[node]) ring.push_back(x);
            aligned_to[target] = ring;
            for (int other : ring) {
              bool has = false;
              for (int x : aligned_to[other]) if (x == target) { has = true; break; }
              if (!has) aligned_to[other].push_back(target);
            }
          }
        }
      }
      if (target < 0) target = new_node(c);
      if (prev >= 0) add_edge(prev, target, 1);
      prev = target;
    }
  }

  std::string consensus() const {
    // Heaviest-bundle traversal (Lee 2003; spoa/poapy GenerateConsensus
    // semantics), mirroring poa.py::consensus with the same explicit
    // tie-breaks: per node, the single heaviest in-edge (ties: higher
    // predecessor score, then smaller node id); end node = best score,
    // ties to the latest in topological order.
    if (ch.empty()) return "";
    std::vector<int> order = topo();
    std::vector<long> score(ch.size(), 0);
    std::vector<int> prev(ch.size(), -1);
    for (int v : order) {
      long best_w = 0, best_ps = -1;
      int best_p = -1;
      for (auto& e : in_e[v]) {
        long w = e.second, ps = score[e.first];
        int p = e.first;
        bool better = best_p < 0
            || w > best_w
            || (w == best_w && ps > best_ps)
            || (w == best_w && ps == best_ps && p < best_p);
        if (better) { best_w = w; best_ps = ps; best_p = p; }
      }
      if (best_p >= 0) { score[v] = best_w + score[best_p]; prev[v] = best_p; }
    }
    int end = order[0];
    long best = score[order[0]];
    for (int v : order) if (score[v] >= best) { end = v; best = score[v]; }
    std::string out;
    int v = end;
    while (v >= 0) { out.push_back(ch[v]); v = prev[v]; }
    std::reverse(out.begin(), out.end());
    return out;
  }
};

}  // namespace poa

// Unit-cost NW edit distance with threshold early-abort; value-identical
// to longtr_tpu/haplotype/cluster.py::edit_distance_banded (transcribing
// HaplotypeGenerator.cpp:201-234): returns the exact distance, or T+1 as
// soon as every band-adjusted cell of a row exceeds T.
extern "C" long ltr_edit_distance_banded(const char* a, long n,
                                         const char* b, long m, long T);

// One query against a packed list of candidates, threaded over candidates
// (greedy clustering computes query-vs-every-centroid; one call + threads
// beats k sequential ctypes crossings on multi-kb VNTR reads).
extern "C" long ltr_edit_distance_batch(const char* a, long n,
                                        const char* bs, const long* lens,
                                        long k, long T, long* out,
                                        long nthreads) {
  std::vector<const char*> ptrs(k);
  {
    const char* p = bs;
    for (long i = 0; i < k; i++) { ptrs[i] = p; p += lens[i]; }
  }
  // caller-provided thread budget (the Python side sizes it to the cores
  // this locus can claim); <=0 means use the hardware count
  unsigned nt = nthreads > 0 ? (unsigned)nthreads
                             : effective_cores();
  if (nt == 0) nt = 4;
  if ((long)nt > k) nt = (unsigned)k;
  std::vector<std::thread> threads;
  std::atomic<long> next(0);
  auto work = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= k) return;
      out[i] = ltr_edit_distance_banded(a, n, ptrs[i], lens[i], T);
    }
  };
  if (nt <= 1) {
    work();
  } else {
    threads.reserve(nt);
    for (unsigned t = 0; t < nt; t++) threads.emplace_back(work);
    for (auto& th : threads) th.join();
  }
  return 0;
}

// Banded block bit-parallel edit distance (Myers 1999 bit-vector recurrence
// in Hyyro's block formulation, with an Ukkonen band over the blocks — the
// same algorithmic family as edlib, implemented from the published
// recurrences).  Pattern = b laid vertically in 64-row blocks; text = a
// consumed one column per step.  Only blocks intersecting the diagonal band
// |i - j| <= T are maintained:
//   * a block strictly BELOW the band has seen no in-band cells yet; its
//     column values are initialized to D[j][0] = j (VP = ~0), an
//     overestimate of the true column — safe, because any path of total
//     cost <= T stays inside the band (cost-so-far >= |i' - j'| at every
//     cell on it), so out-of-band overestimates can never change an
//     in-band value that is <= T;
//   * a block strictly ABOVE the band is dropped, and the carry fed to the
//     block below it is +1 (columns far above the diagonal eventually grow
//     by one per step; again at most an out-of-band overestimate).
// Result contract (identical to the scalar band DP this replaces, which is
// kept below as ltr_edit_distance_banded_scalar for differential fuzzing):
// the exact distance when d <= T, else T + 1.  O(n * T/64) word ops.
namespace bpmyers {

struct Block {
  uint64_t VP, VN;
  long score;   // D[end_row][current column]
};

// One Myers block step: consume text char (Eq = match bits of this block),
// carry hin in {-1,0,+1} from the block above; returns hout at `hbit` (the
// block's end row) and updates VP/VN/score.
static inline int step(Block& B, uint64_t Eq, int hin, uint64_t hbit) {
  uint64_t VP = B.VP, VN = B.VN;
  uint64_t Xv = Eq | VN;
  if (hin < 0) Eq |= 1ULL;
  uint64_t Xh = (((Eq & VP) + VP) ^ VP) | Eq;
  uint64_t Ph = VN | ~(Xh | VP);
  uint64_t Mh = VP & Xh;
  int hout = 0;
  if (Ph & hbit) hout = 1;
  else if (Mh & hbit) hout = -1;
  Ph <<= 1;
  Mh <<= 1;
  if (hin > 0) Ph |= 1ULL;
  else if (hin < 0) Mh |= 1ULL;
  B.VP = Mh | ~(Xv | Ph);
  B.VN = Ph & Xv;
  B.score += hout;
  return hout;
}

}  // namespace bpmyers

static long myers_banded(const uint8_t* a, long n, const uint8_t* b, long m,
                         long T) {
  using bpmyers::Block;
  const long W = (m + 63) >> 6;
  // remap the pattern alphabet to dense ids (DNA: ~4-5 symbols)
  uint8_t map[256];
  memset(map, 0xff, sizeof(map));
  int sigma = 0;
  for (long j = 0; j < m; j++) {
    uint8_t c = b[j];
    if (map[c] == 0xff) map[c] = (uint8_t)sigma++;
  }
  std::vector<uint64_t> Peq((size_t)W * sigma, 0);
  for (long j = 0; j < m; j++)
    Peq[(size_t)(j >> 6) * sigma + map[b[j]]] |= 1ULL << (j & 63);
  std::vector<Block> blk(W);
  std::vector<uint64_t> hbit(W);
  for (long t = 0; t < W; t++) {
    long end_row = (t == W - 1) ? m : (t + 1) * 64;   // 1-based
    hbit[t] = 1ULL << ((end_row - 1) & 63);
  }
  // block t covers 1-based rows [t*64+1, min(m,(t+1)*64)]; active window
  // [first, last] = blocks intersecting the band at the current column
  long first = 0, last = -1;
  auto admit = [&](long i) {        // admit blocks whose top row <= i + T
    while (last + 1 < W && (last + 1) * 64 + 1 <= i + T) {
      // a freshly admitted block assumes D[j][i-1] = (value at the block
      // above's end row at column i-1) + (j - that row): all-+1 vertical
      // deltas chained off the LIVE block above (edlib-style), an upper
      // bound on the true column (D[j][c] <= D[r][c] + (j - r)), which the
      // band argument makes safe.  Anchoring to column 0 instead would
      // break the cross-block delta chain.
      long prev_end = (last >= 0) ? ((last + 1) * 64) : 0;
      long base = (last >= 0) ? blk[last].score : (i > 0 ? i - 1 : 0);
      last++;
      blk[last].VP = ~0ULL;
      blk[last].VN = 0;
      long end_row = (last == W - 1) ? m : (last + 1) * 64;
      blk[last].score = base + (end_row - prev_end);
    }
  };
  admit(0);   // blocks in-band before any text is consumed (column 0)
  for (long i = 1; i <= n; i++) {
    admit(i);
    // retire blocks fully above the band (end row < i - T)
    while (first < last && (first + 1) * 64 < i - T) first++;
    const uint8_t id = map[a[i - 1]];
    int hin = 1;   // row-0 boundary D[0][i] = i; +1 overestimate if first>0
    long col_min = (long)1 << 60;
    for (long t = first; t <= last; t++) {
      uint64_t Eq = (id == 0xff) ? 0 : Peq[(size_t)t * sigma + id];
      hin = bpmyers::step(blk[t], Eq, hin, hbit[t]);
      if (blk[t].score < col_min) col_min = blk[t].score;
    }
    // weak early abort: every cell in an active block is >= score - 63;
    // cells outside the active window are out-of-band (> T); if the whole
    // column is > T, all later columns are too (row-0 boundary included)
    if (col_min - 63 > T) return T + 1;
  }
  long out = blk[W - 1].score;
  return out > T ? T + 1 : out;
}

extern "C" long ltr_edit_distance_banded(const char* a, long n,
                                         const char* b, long m, long T) {
  long diff = n - m;
  if (diff < 0 ? (-diff > T) : (diff > T)) return T + 1;
  // Reference empty-string asymmetry (HaplotypeGenerator.cpp:220-231): an
  // empty b (read_seq, the centroid in clustering) makes the per-row abort
  // fire unconditionally -> T+1; an empty a skips the row loop entirely
  // and returns the exact dp value m.
  if (m == 0) return n == 0 ? 0 : T + 1;
  if (n == 0) return m;  // <= T by the length check above
  return myers_banded((const uint8_t*)a, n, (const uint8_t*)b, m, T);
}

extern "C" long ltr_edit_distance_banded_scalar(const char* a, long n,
                                                const char* b, long m,
                                                long T) {
  long diff = n - m;
  if (diff < 0 ? (-diff > T) : (diff > T)) return T + 1;
  if (m == 0) return n == 0 ? 0 : T + 1;
  if (n == 0) return m;  // <= T by the length check above
  // Ukkonen band: unit-cost edit distance satisfies d[i][j] >= |i-j|, so
  // cells with |i-j| > T can never contribute a value <= T.  Computing
  // only the 2T+1 diagonal band gives values <= T exactly and clamps
  // everything else to T+1 — decision-identical at every call site
  // (clustering compares `score < threshold` only; contract documented
  // in haplotype/cluster.py and PARITY.md).  O(n*T) instead of O(n*m).
  const long W = 2 * T + 1;
  const int32_t CLAMP = (int32_t)(T + 1);
  std::vector<int32_t> prev(W + 2), cur(W + 2);
  // offset k = j - i + T; rows padded with CLAMP sentinels at both ends
  int32_t* pv = prev.data() + 1;
  int32_t* cv = cur.data() + 1;
  prev[0] = cur[0] = CLAMP;
  prev[W + 1] = cur[W + 1] = CLAMP;
  for (long k = 0; k < W; k++) {
    long j = k - T;                     // row 0: d[0][j] = j
    pv[k] = (j >= 0 && j <= m) ? (int32_t)(j < CLAMP ? j : CLAMP) : CLAMP;
  }
  for (long i = 1; i <= n; i++) {
    const char ai = a[i - 1];
    int32_t row_min = CLAMP;
    long kmin = 0;
    if (i <= T) {
      // column j=0 sits inside the band at offset T-i
      const long k0 = T - i;
      for (long k = 0; k < k0; k++) cv[k] = CLAMP;
      cv[k0] = (int32_t)(i < CLAMP ? i : CLAMP);
      if (cv[k0] < row_min) row_min = cv[k0];
      kmin = k0 + 1;
    }
    const long kmax = (i + T <= m) ? W - 1 : m - i + T;
    const char* bj = b + (i + kmin - T - 1);
    for (long k = kmin; k <= kmax; k++) {
      int32_t d = pv[k] + (ai != bj[k - kmin]);       // diag: (i-1, j-1)
      int32_t u = pv[k + 1] + 1;                      // up:   (i-1, j)
      int32_t l = cv[k - 1] + 1;                      // left: (i,   j-1)
      int32_t v = d < u ? d : u;
      if (l < v) v = l;
      if (v > CLAMP) v = CLAMP;
      cv[k] = v;
      if (v < row_min) row_min = v;
    }
    for (long k = kmax + 1; k < W; k++) cv[k] = CLAMP;
    if (row_min >= CLAMP) return T + 1;   // no path <= T can survive
    std::swap(pv, cv);
  }
  int32_t out = pv[m - n + T];
  return out > T ? T + 1 : out;
}

extern "C" long ltr_poa_consensus(const char* seqs, const long* lens,
                                  long n_seqs, char* out, long out_cap) {
  poa::Graph g;
  const char* p = seqs;
  for (long i = 0; i < n_seqs; i++) {
    g.add_sequence(p, (int)lens[i]);
    p += lens[i];
  }
  std::string c = g.consensus();
  if ((long)c.size() > out_cap) return -1;
  std::copy(c.begin(), c.end(), out);
  return (long)c.size();
}

// ---------------------------------------------------------------------------
// Batch pair-HMM (mode A) for the host CPU path.  Mirrors
// longtr_tpu/ops/pairhmm.py::pairhmm_scan operation-for-operation in f32
// (same expression order, no FMA contraction — the library builds with
// -ffp-contract=off) so results are bit-identical to the jnp scan and the
// CUDA kernel.  Vectorizes over a tile of pairs in the inner loops.

#include <cmath>
#include <cstdlib>
#include <chrono>
#include <cstring>

namespace phmm {

constexpr float NEG = -1000000000.0f;       // IMPOSSIBLE
constexpr float MA = -0.000100005f;         // MATCH_EMIT
constexpr float MI = -9.0f;                 // MISMATCH_EMIT
constexpr float BAND_FAIL = -700.0f;
constexpr float BAND_THRESH = -600.0f;
constexpr int LEN_DIFF_LIMIT = 600;
constexpr int MIN_FULL_HAP_LEN = 60;

inline float fmaxf2(float a, float b) { return a > b ? a : b; }

}  // namespace phmm

static void pairhmm_range(
    const uint8_t* hap, const uint8_t* read,
    const int32_t* hap_len, const int32_t* read_len,
    const int32_t* full_hap_len, const float* trans,
    long b_lo, long b_hi, long N, long Mdim, float* out) {
  using namespace phmm;
  const float i2i = trans[0], i2m = trans[1], d2d = trans[2], d2m = trans[3],
              m2m = trans[4], m2i = trans[5], m2d = trans[6];

  // Transposed tiles: TL pairs ride the SIMD lanes; every inner loop over
  // t vectorizes, including the D running max (independent per lane, same
  // op order as the jnp scan).
  constexpr long TL = 16;
  std::vector<float> Mp(Mdim * TL), Ip(Mdim * TL), Dp(Mdim * TL),
      Mn(Mdim * TL), In(Mdim * TL), Dn(Mdim * TL);
  std::vector<uint8_t> rt(Mdim * TL), ht(N * TL);
  std::vector<int> nL(TL), mL(TL);
  std::vector<float> col0_emit(TL), run(TL), row_best(TL), outv(TL);
  std::vector<uint8_t> bandfail(TL);
  std::vector<long> cornj(TL);

  for (long b0 = b_lo; b0 < b_hi; b0 += TL) {
    const long tl = (b0 + TL <= b_hi) ? TL : (b_hi - b0);
    int max_n = 1;
    for (long t = 0; t < TL; t++) {
      long b = (t < tl) ? b0 + t : b0;        // clone last lanes; discarded
      nL[t] = hap_len[b];
      mL[t] = read_len[b];
      if (nL[t] > max_n) max_n = nL[t];
      for (long j = 0; j < Mdim; j++) rt[j * TL + t] = read[b * Mdim + j];
      for (long j = 0; j < N; j++) ht[j * TL + t] = hap[b * N + j];
      cornj[t] = mL[t] - 1 < 0 ? 0 : (mL[t] - 1 >= Mdim ? Mdim - 1 : mL[t] - 1);
    }

    // row 0 init
    for (long j = 0; j < Mdim; j++) {
      float Dk = (j >= 1) ? m2d + (float)(j - 1) * d2d : NEG;
      float Dk_prev = (j >= 2) ? m2d + (float)(j - 2) * d2d : NEG;
      for (long t = 0; t < TL; t++) {
        uint8_t r0 = rt[t];
        float emit0 = ((j < N ? ht[j * TL + t] : 0) == r0) ? MA : MI;
        float M0 = (j == 0) ? ((ht[t] == r0) ? MA : MI)
                            : Dk_prev + d2m + emit0;
        bool valid = j < mL[t];
        Mp[j * TL + t] = valid ? M0 : NEG;
        Dp[j * TL + t] = valid ? Dk : NEG;
        Ip[j * TL + t] = NEG;
      }
    }
    for (long t = 0; t < TL; t++) {
      uint8_t c0r = (mL[t] > 1) ? rt[TL + t] : rt[t];
      col0_emit[t] = (ht[t] == c0r) ? MA : MI;
      float c = fmaxf2(fmaxf2(Mp[cornj[t] * TL + t], Ip[cornj[t] * TL + t]),
                       Dp[cornj[t] * TL + t]);
      outv[t] = (nL[t] == 1) ? c : NEG;
      bandfail[t] = 0;
    }
    // Lanes whose score is decided without the DP (length shortcut /
    // short-haplotype NEG) count as done for the tile early-exit below;
    // their outv is overridden at emission either way.
    std::vector<uint8_t> decided(TL, 0);
    for (long t = 0; t < tl; t++) {
      long b = b0 + t;
      int diff = nL[t] - mL[t];
      if ((diff < 0 ? -diff : diff) > LEN_DIFF_LIMIT ||
          full_hap_len[b] <= MIN_FULL_HAP_LEN)
        decided[t] = 1;
    }

    for (int i = 1; i < max_n; i++) {
      // M and I rows (j >= 1)
      const uint8_t* hrow = &ht[(long)i * TL];
      for (long j = Mdim - 1; j >= 1; j--) {
        for (long t = 0; t < TL; t++) {
          float emit = (hrow[t] == rt[j * TL + t]) ? MA : MI;
          float pm = Mp[(j - 1) * TL + t] + m2m;
          float pd = Dp[(j - 1) * TL + t] + d2m;
          float pi = Ip[(j - 1) * TL + t] + i2m;
          Mn[j * TL + t] = emit + fmaxf2(fmaxf2(pm, pd), pi);
          In[j * TL + t] = MA + fmaxf2(Mp[j * TL + t] + m2i,
                                       Ip[j * TL + t] + i2i);
        }
      }
      for (long t = 0; t < TL; t++) {
        Mn[t] = Ip[t] + i2m + col0_emit[t];
        In[t] = MA + m2i + (float)(i - 1) * i2i;
        run[t] = -INFINITY;
        Dn[t] = NEG;
      }
      // D running max (same op order as the scan's cummax trick)
      for (long j = 0; j < Mdim; j++) {
        float jm = m2d - (float)(j + 1) * d2d;
        float jd = (float)(j + 1) * d2d;
        for (long t = 0; t < TL; t++) {
          float c = Mn[j * TL + t] + m2d - (float)(j + 1) * d2d;
          run[t] = fmaxf2(run[t], c);
          if (j + 1 < Mdim) Dn[(j + 1) * TL + t] = jd + run[t];
        }
        (void)jm;
      }
      // masks + band + corner + keep
      for (long t = 0; t < TL; t++) row_best[t] = NEG;
      for (long j = 0; j < Mdim; j++) {
        for (long t = 0; t < TL; t++) {
          bool valid = j < mL[t];
          float mv = valid ? Mn[j * TL + t] : NEG;
          float iv = valid ? In[j * TL + t] : NEG;
          float dv = valid ? Dn[j * TL + t] : NEG;
          float best = fmaxf2(fmaxf2(mv, iv), dv);
          bool in_band = j >= 1 && (long)j <= (long)mL[t] - 1;
          int bd = (nL[t] - mL[t]) - (i - (int)j);
          float band = (float)(bd < 0 ? -bd : bd) * d2d;
          float cand = best + band;
          if (in_band && cand > row_best[t]) row_best[t] = cand;
          bool keep = i <= nL[t] - 1;
          Mn[j * TL + t] = keep ? mv : Mp[j * TL + t];
          In[j * TL + t] = keep ? iv : Ip[j * TL + t];
          Dn[j * TL + t] = keep ? dv : Dp[j * TL + t];
        }
      }
      for (long t = 0; t < TL; t++) {
        bool active = i <= nL[t] - 1;
        if (active && row_best[t] < BAND_THRESH) bandfail[t] = 1;
        if (i == nL[t] - 1) {
          long cj = cornj[t];
          outv[t] = fmaxf2(fmaxf2(Mn[cj * TL + t], In[cj * TL + t]),
                           Dn[cj * TL + t]);
        }
      }
      Mp.swap(Mn);
      Ip.swap(In);
      Dp.swap(Dn);
      // Tile early-exit: the band-fail flag is sticky (score becomes
      // BAND_FAIL no matter what later rows hold — same semantics as the
      // accumulated fail flag in the scan), and a lane past its
      // last haplotype row is frozen.  Once every real lane is failed,
      // decided, or complete, later rows cannot change any output.
      bool all_done = true;
      for (long t = 0; t < tl; t++)
        if (!(bandfail[t] || decided[t] || i >= nL[t] - 1)) {
          all_done = false;
          break;
        }
      if (all_done) break;
    }

    for (long t = 0; t < tl; t++) {
      long b = b0 + t;
      float score = bandfail[t] ? BAND_FAIL : outv[t];
      int diff = nL[t] - mL[t];
      if ((diff < 0 ? -diff : diff) > LEN_DIFF_LIMIT) score = BAND_FAIL;
      if (full_hap_len[b] <= MIN_FULL_HAP_LEN) score = NEG;
      out[b] = score;
    }
  }
}

// ---------------------------------------------------------------------------
// Float64 pair-HMM (reference-fidelity mode A).  Mirrors the reference's
// align_seq_to_hap (HapAligner.cpp:236-343) exactly: double matrices, float
// transition/emission constants, the row-0 hap[j]-vs-read[0] and col-0
// read[1] boundary quirks, the per-row band abort and the |n-m|>600 and
// full-hap<=60 gates.  Bit-identical to the compiled reference (verified by
// tests/test_ref_oracle.py).  Rolling rows: O(m) memory per thread.

static double pairhmm_f64_single(const uint8_t* hap, int n,
                                 const uint8_t* read, int m,
                                 int full_hap_len, const float* trans) {
  const double IMPOSSIBLE = -1000000000.0;
  const float MA = -0.000100005f;
  const float MI = -9.0f;
  if (full_hap_len <= 60) return IMPOSSIBLE;
  int diff = n - m;
  if ((diff < 0 ? -diff : diff) > 600) return -700.0;

  const float i2i = trans[0], i2m = trans[1], d2d = trans[2], d2m = trans[3],
              m2m = trans[4], m2i = trans[5], m2d = trans[6];

  std::vector<double> Mp(m), Ip(m), Dp(m), Mc(m), Ic(m), Dc(m);
  // row 0 (HapAligner.cpp:263-272): M[j] uses D[j-1] before D[j] updates
  Mp[0] = (hap[0] == read[0]) ? (double)MA : (double)MI;
  Ip[0] = IMPOSSIBLE;
  Dp[0] = IMPOSSIBLE;
  double left = 0.0;
  for (int j = 1; j < m; j++) {
    double emit = (j < n && hap[j] == read[0]) ? (double)MA : (double)MI;
    Mp[j] = Dp[j - 1] + d2m + emit;
    Ip[j] = IMPOSSIBLE;
    Dp[j] = m2d + left;
    left += d2d;
  }
  if (n == 1) {
    double best = Mp[m - 1];
    if (Ip[m - 1] > best) best = Ip[m - 1];
    if (Dp[m - 1] > best) best = Dp[m - 1];
    return best;
  }

  uint8_t col0_read = (m > 1) ? read[1] : read[0];
  left = 0.0;
  for (int i = 1; i < n; i++) {
    // col 0 (HapAligner.cpp:274-280).  NOTE: MATCH + LOG_MATCH_TO_INS is a
    // float+float addition in the reference (both operands float) before
    // the double accumulator joins — order preserved for bit-identity.
    double emit0 = (hap[0] == col0_read) ? (double)MA : (double)MI;
    Mc[0] = Ip[0] + i2m + emit0;
    Ic[0] = (MA + m2i) + left;
    Dc[0] = IMPOSSIBLE;
    left += i2i;

    double row_best = IMPOSSIBLE;
    for (int j = 1; j < m; j++) {
      double emit = (hap[i] == read[j]) ? (double)MA : (double)MI;
      double vm = Mp[j - 1] + m2m;
      double vd = Dp[j - 1] + d2m;
      double vi = Ip[j - 1] + i2m;
      double best3 = vm > vd ? vm : vd;
      if (vi > best3) best3 = vi;
      Mc[j] = emit + best3;
      double im = Mp[j] + m2i;
      double ii = Ip[j] + i2i;
      Ic[j] = (double)MA + (im > ii ? im : ii);
      double dm = Mc[j - 1] + m2d;
      double dd = Dc[j - 1] + d2d;
      Dc[j] = dm > dd ? dm : dd;
      double best = Mc[j];
      if (Ic[j] > best) best = Ic[j];
      if (Dc[j] > best) best = Dc[j];
      int bd = (n - m) - (i - j);
      double cand = best + (bd < 0 ? -bd : bd) * d2d;  // int*float, then +
      if (cand > row_best) row_best = cand;
    }
    if (row_best < -600.0) return -700.0;
    Mp.swap(Mc);
    Ip.swap(Ic);
    Dp.swap(Dc);
  }
  double best = Mp[m - 1];
  if (Ip[m - 1] > best) best = Ip[m - 1];
  if (Dp[m - 1] > best) best = Dp[m - 1];
  return best;
}

#include <thread>

static void pairhmm_f64_range(const uint8_t* hap, const uint8_t* read,
                              const int32_t* hap_len, const int32_t* read_len,
                              const int32_t* full_hap_len, const float* trans,
                              long b_lo, long b_hi, long N, long Mdim,
                              double* out) {
  for (long b = b_lo; b < b_hi; b++)
    out[b] = pairhmm_f64_single(hap + b * N, hap_len[b], read + b * Mdim,
                                read_len[b], full_hap_len[b], trans);
}

extern "C" void ltr_pairhmm_batch_f64(
    const uint8_t* hap, const uint8_t* read,       // (B, N), (B, M) row-major
    const int32_t* hap_len, const int32_t* read_len,
    const int32_t* full_hap_len, const float* trans,  // 7
    long B, long N, long Mdim, double* out) {
  unsigned nt = effective_cores();
  const char* env = getenv("LONGTR_NATIVE_THREADS");
  if (env && *env) nt = (unsigned)atoi(env);
  if (nt < 1) nt = 1;
  if ((long)nt > B) nt = (unsigned)B;
  if (nt == 1) {
    pairhmm_f64_range(hap, read, hap_len, read_len, full_hap_len, trans,
                      0, B, N, Mdim, out);
    return;
  }
  std::vector<std::thread> ths;
  long chunk = (B + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    long lo = (long)t * chunk;
    long hi = lo + chunk < B ? lo + chunk : B;
    if (lo >= hi) break;
    ths.emplace_back(pairhmm_f64_range, hap, read, hap_len, read_len,
                     full_hap_len, trans, lo, hi, N, Mdim, out);
  }
  for (auto& th : ths) th.join();
}

extern "C" void ltr_pairhmm_batch(
    const uint8_t* hap, const uint8_t* read,       // (B, N), (B, M) row-major
    const int32_t* hap_len, const int32_t* read_len,
    const int32_t* full_hap_len, const float* trans,  // 7
    long B, long N, long Mdim, float* out) {
  unsigned nt = effective_cores();
  const char* env = getenv("LONGTR_NATIVE_THREADS");
  if (env && *env) nt = (unsigned)atoi(env);
  if (nt < 1) nt = 1;
  if ((long)nt > B) nt = (unsigned)B;
  if (nt == 1) {
    pairhmm_range(hap, read, hap_len, read_len, full_hap_len, trans,
                  0, B, N, Mdim, out);
    return;
  }
  std::vector<std::thread> ths;
  long chunk = (B + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    long lo = (long)t * chunk;
    long hi = lo + chunk < B ? lo + chunk : B;
    if (lo >= hi) break;
    ths.emplace_back(pairhmm_range, hap, read, hap_len, read_len,
                     full_hap_len, trans, lo, hi, N, Mdim, out);
  }
  for (auto& th : ths) th.join();
}

// ---------------------------------------------------------------------------
// Batched read trim + CIGAR expansion (one call per locus).
//
// Native fast path for pipeline/alignment.left_align_reads: the reference
// trims each BAM record to region±FLANK_SIZE and expands its CIGAR into
// explicit =/X ops against the chromosome (bam_io.cpp:267-372 TrimAlignment
// + genotyper_bam_processor.cpp:72-140).  Transcribes the (oracle-tested)
// Python implementations in io/bam.py::trim_alignment and
// pipeline/alignment.py::expand_cigar_vs_ref run-for-run; the Python path
// remains as the fallback and the identity test's reference.
//
// Per-read meta layout (8 int64 each):
//   [0] status: 0=keep 1=overlap_fail 2=softclip_fail 3=del_alignment
//               4=bad_cigar
//   [1] new_pos  [2] new_end_pos(exclusive)  [3] ltrim  [4] rtrim
//   [5] n_out_cigar  [6] aln_len  [7] deleted(0/1)
//
// Output capacity contract (caller allocates):
//   out_ops/out_lens: total input cigar entries + total seq bytes
//   out_aln: total seq bytes + R * (max_read_stop - min_read_start + 2)
// Returns 0, or -1 if a capacity or bounds invariant is violated.
extern "C" int64_t ltr_trim_expand_batch(
    const char* chrom, int64_t chrom_off, int64_t chrom_len,  // window
    const char* seqs, const int64_t* seq_off,                  // R+1
    const uint8_t* ops, const int32_t* oplens, const int64_t* cig_off,  // R+1
    const int64_t* pos, const int64_t* end_pos, int64_t R,
    int64_t min_read_start, int64_t max_read_stop, int64_t flank_size,
    int64_t region_start, int64_t region_stop,
    uint8_t* out_ops, int32_t* out_lens, int64_t out_cig_cap,
    char* out_aln, int64_t out_aln_cap,
    int64_t* out_cig_offs, int64_t* out_aln_offs,              // R+1 each
    int64_t* meta) {
  int64_t cig_w = 0, aln_w = 0;
  std::vector<uint8_t> t_ops;
  std::vector<int64_t> t_lens;
  out_cig_offs[0] = 0;
  out_aln_offs[0] = 0;
  for (int64_t r = 0; r < R; r++) {
    int64_t* m = meta + r * 8;
    for (int k = 0; k < 8; k++) m[k] = 0;
    out_cig_offs[r + 1] = cig_w;
    out_aln_offs[r + 1] = aln_w;
    const int64_t slo = seq_off[r], shi = seq_off[r + 1];
    const int64_t seq_len = shi - slo;
    const char* seq = seqs + slo;
    const int64_t clo = cig_off[r], chi = cig_off[r + 1];
    // overlap gate (genotyper_bam_processor.cpp:56-59)
    if (pos[r] > region_start || end_pos[r] < region_stop) {
      m[0] = 1;
      continue;
    }
    // ---- trim (io/bam.py trim_alignment; bam_io.cpp:267-372) ----
    t_ops.assign(ops + clo, ops + chi);
    t_lens.assign(oplens + clo, oplens + chi);
    int64_t nc = chi - clo;
    int64_t ltrim = 0, start_pos = pos[r];
    int64_t ci = 0;
    bool bad = false;
    while (start_pos < min_read_start && ci < nc) {
      uint8_t op = t_ops[ci];
      int64_t n = t_lens[ci], take;
      if (op == 'M' || op == '=' || op == 'X') {
        take = n < min_read_start - start_pos ? n : min_read_start - start_pos;
        ltrim += take;
        start_pos += take;
      } else if (op == 'D') {
        take = n < min_read_start - start_pos ? n : min_read_start - start_pos;
        start_pos += take;
      } else if (op == 'I' || op == 'S') {
        take = n;
        ltrim += n;
      } else if (op == 'H') {
        take = n;
      } else {
        bad = true;
        break;
      }
      if (take == n) ci++;
      else t_lens[ci] = n - take;
    }
    if (bad) { m[0] = 4; continue; }
    int64_t base = ci;  // trimmed cigar = [base, nc)
    // whole-repeat deletion detection (bam_io.cpp:304-337)
    int64_t repeat_pointer = start_pos;
    const int64_t repeat_start = min_read_start + flank_size;
    const int64_t repeat_end = max_read_stop - flank_size;
    int64_t deletion_size = 0;
    if (repeat_pointer >= min_read_start) {
      for (int64_t k = base; k < nc; k++) {
        if (repeat_pointer >= repeat_end) break;
        uint8_t op = t_ops[k];
        int64_t n = t_lens[k];
        if (op == 'M' || op == '=' || op == 'X') {
          int64_t adv = n < repeat_end - repeat_pointer
                            ? n : repeat_end - repeat_pointer;
          repeat_pointer += adv;
        } else if (op == 'D') {
          int64_t take = n < repeat_end - repeat_pointer
                             ? n : repeat_end - repeat_pointer;
          int64_t lo2 = repeat_pointer > repeat_start
                            ? repeat_pointer : repeat_start;
          int64_t hi2 = repeat_pointer + take;
          if (hi2 > lo2) deletion_size += hi2 - lo2;
          repeat_pointer += take;
        }
      }
    }
    if (deletion_size >= repeat_end - repeat_start) m[7] = 1;
    // right trim
    int64_t rtrim = 0, cur_end = end_pos[r];
    int64_t ce = nc;  // trimmed cigar = [base, ce)
    while (cur_end > max_read_stop && ce > base) {
      uint8_t op = t_ops[ce - 1];
      int64_t n = t_lens[ce - 1], take;
      if (op == 'M' || op == '=' || op == 'X') {
        take = n < cur_end - max_read_stop ? n : cur_end - max_read_stop;
        rtrim += take;
        cur_end -= take;
      } else if (op == 'D') {
        take = n < cur_end - max_read_stop ? n : cur_end - max_read_stop;
        cur_end -= take;
      } else if (op == 'I' || op == 'S') {
        take = n;
        rtrim += n;
      } else if (op == 'H') {
        take = n;
      } else {
        bad = true;
        break;
      }
      if (take == n) ce--;
      else t_lens[ce - 1] = n - take;
    }
    if (bad) { m[0] = 4; continue; }
    if (ltrim + rtrim > seq_len) return -1;
    m[1] = start_pos;
    m[2] = cur_end;
    m[3] = ltrim;
    m[4] = rtrim;
    if (seq_len - ltrim - rtrim == 0) { m[0] = 3; continue; }
    // ---- expand (pipeline/alignment.py expand_cigar_vs_ref) ----
    int64_t seq_index = ltrim;
    int64_t ref_index = start_pos;
    bool soft = false;
    const int64_t cig_start = cig_w;
    const int64_t aln_start = aln_w;
    for (int64_t k = base; k < ce && !bad; k++) {
      uint8_t op = t_ops[k];
      int64_t n = t_lens[k];
      // Reference parity: the reference appends one CigarElement per
      // source element and only coalesces =/X runs WITHIN one M/=/X
      // element (genotyper_bam_processor.cpp:80-130) — never across
      // source elements and never for S/I/D.
      const int64_t elem_start = cig_w;
      if (op == 'H') continue;
      if (op == 'S') {
        if (cig_w >= out_cig_cap) return -1;
        out_ops[cig_w] = 'S';
        out_lens[cig_w++] = (int32_t)n;
        seq_index += n;
        soft = true;
      } else if (op == 'I') {
        if (cig_w >= out_cig_cap) return -1;
        out_ops[cig_w] = 'I';
        out_lens[cig_w++] = (int32_t)n;
        if (aln_w + n > out_aln_cap) return -1;
        for (int64_t t = 0; t < n; t++)
          out_aln[aln_w++] = (char)toupper((unsigned char)seq[seq_index + t]);
        seq_index += n;
      } else if (op == 'D') {
        if (cig_w >= out_cig_cap) return -1;
        out_ops[cig_w] = 'D';
        out_lens[cig_w++] = (int32_t)n;
        if (aln_w + n > out_aln_cap) return -1;
        for (int64_t t = 0; t < n; t++) out_aln[aln_w++] = '-';
        ref_index += n;
      } else if (op == 'M' || op == '=' || op == 'X') {
        if (aln_w + n > out_aln_cap) return -1;
        for (int64_t t = 0; t < n; t++) {
          char rb = (char)toupper((unsigned char)seq[seq_index + t]);
          int64_t ref_pos = ref_index + t - chrom_off;
          char fb = (ref_pos >= 0 && ref_pos < chrom_len)
                        ? (char)toupper((unsigned char)chrom[ref_pos]) : '\0';
          uint8_t eq = rb == fb ? '=' : 'X';
          out_aln[aln_w] = rb;
          aln_w++;
          if (cig_w > elem_start && out_ops[cig_w - 1] == eq)
            out_lens[cig_w - 1]++;
          else {
            if (cig_w >= out_cig_cap) return -1;
            out_ops[cig_w] = eq;
            out_lens[cig_w++] = 1;
          }
        }
        seq_index += n;
        ref_index += n;
      } else {
        bad = true;
      }
    }
    if (bad) { m[0] = 4; cig_w = cig_start; aln_w = aln_start; continue; }
    if (soft) { m[0] = 2; cig_w = cig_start; aln_w = aln_start; continue; }
    m[0] = 0;
    m[5] = cig_w - cig_start;
    m[6] = aln_w - aln_start;
    out_cig_offs[r + 1] = cig_w;
    out_aln_offs[r + 1] = aln_w;
  }
  // final offsets for trailing skipped reads
  for (int64_t r = 0; r < R; r++) {
    if (out_cig_offs[r + 1] < out_cig_offs[r]) out_cig_offs[r + 1] = out_cig_offs[r];
    if (out_aln_offs[r + 1] < out_aln_offs[r]) out_aln_offs[r + 1] = out_aln_offs[r];
  }
  return 0;
}

// Fused read -> MinHash sketch, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   metacache_tpu/ops/sketch_pallas.py::sketch_packed_pallas
// (kernel body _make_kernel, prologue _ambig_2bit_plane). It computes the
// same numbers: for every read b and static window start s, each
// canonical k-mer that lies inside the window and the read and touches
// no ambiguous base is hashed with Thomas-Mueller, and the `sketch_size`
// smallest DISTINCT hashes are written in ascending order, padded with
// 0xFFFFFFFF (single_function_unique_min_hasher, reference
// src/hash_dna.h:50-182). A hash equal to 0xFFFFFFFF never enters a
// sketch. Unlike the Pallas kernel it takes any 1 <= k <= 16, any B, any
// window size and sketch sizes up to kMaxSketch.
//
// What bounds it on the card: integer ALU work and, before that, latency.
// A 100 bp read arrives as ~26 bytes of 2-bit codes (+13 bytes of
// ambiguity bits) and costs ~85 k-mer assemblies, reverse complements and
// hashes plus the selection of the s smallest, so memory traffic is
// negligible next to the integer instructions; a serial walk per thread
// leaves the SMs starved of warps. The design:
//   - one warp per (read, window), kWarps warps per block, so config-2's
//     16,384 reads run as 16,384 warps;
//   - the window is cut into chunks of kChunk k-mer starts. A chunk's
//     packed and ambiguity bytes are staged in the warp's slice of shared
//     memory; lane l then assembles the k-mers starting at l, l + 32, ...
//     with one funnel shift each (no serial rolling), and a k-mer is
//     valid when the k ambiguity bits of its span are all clear;
//   - selection in registers and warp reductions, no per-thread array in
//     local memory: the sketch so far (value of rank r in lane r % 32,
//     slot r / 32) and the chunk's candidates are merged by s rounds of
//     __reduce_min_sync, each taking the smallest value left and clearing
//     every copy of it, so duplicates fall out by themselves. Once the
//     sketch is full, candidates at or above its largest value are
//     dropped before the merge, and a chunk with none left skips it;
//   - the sketch is stored by the warp at once, 32 lanes on 32
//     consecutive int64 words.
//
// A second entry, mc_sketch_windows, sketches the build's reference
// windows: every window of a batch of whole records as read (ASCII), the
// same per-window function, in place of the host's native sketcher. It
// shares the k-mer hash and the merge with the read kernel (inlined
// device functions: the read kernel's code and time are unchanged) and
// differs only in how a chunk is staged: each warp loads 32 characters at
// a time and builds the packed and ambiguity words with three ballots.
// Its bytes are the records' (~1 byte a k-mer start) and its output; its
// operations, as the read kernel's, are the k-mer work, so it is bound by
// operations at the build's windows.
//
// Plain C interface, bound with ctypes (metacache_tpu_torch/ops/
// sketch_cuda.py, built by ops/cuda_build.py). The launchers return
// cudaGetLastError() after the launch; the caller allocates every buffer.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSketch = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;               // warps (windows) per block
constexpr int kPasses = 4;              // 32 k-mer starts per pass
constexpr int kChunk = 32 * kPasses;    // k-mer starts per chunk
// staged characters of a chunk: up to 3 (7) before its first k-mer in
// the first packed (ambiguity) byte, kChunk starts, 15 more of the last
// k-mer, and one word of slack for the funnel shifts
constexpr int kPackedWords = (3 + kChunk + 15) / 16 + 2;
constexpr int kAmbigWords = (7 + kChunk + 15) / 32 + 2;

__device__ __forceinline__ uint32_t tm_hash(uint32_t x) {
  x = ((x >> 16) ^ x) * 0x45D9F3Bu;
  x = ((x >> 16) ^ x) * 0x45D9F3Bu;
  return (x >> 16) ^ x;
}

// Reverses the order of the sixteen 2-bit groups of x.
__device__ __forceinline__ uint32_t reverse_groups(uint32_t x) {
  const uint32_t y = __brev(x);
  return ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
}

// The hash of the k-mer whose first character is character u of the
// staged packed words sp (16 characters a word, character i at bits 2i)
// and character ua of the staged ambiguity words sa (32 a word), or
// kSentinel if one of its k characters is ambiguous.
__device__ __forceinline__ uint32_t staged_kmer_hash(const uint32_t* sp,
                                                     const uint32_t* sa,
                                                     int u, int ua, int k,
                                                     uint32_t kmask,
                                                     uint32_t amask) {
  const uint32_t amb =
      __funnelshift_r(sa[ua >> 5], sa[(ua >> 5) + 1], ua & 31);
  if ((amb & amask) != 0) return kSentinel;
  // character i of the k-mer at bits 2i
  const uint32_t x =
      __funnelshift_r(sp[u >> 4], sp[(u >> 4) + 1], 2 * (u & 15)) & kmask;
  // the k-mer with its first character highest (src/dna_encoding.h), and
  // its reverse complement
  const uint32_t fwd = reverse_groups(x) >> (32 - 2 * k);
  const uint32_t rc = ~x & kmask;
  return tm_hash(min(fwd, rc));
}

// Merges a chunk's candidates (cand, kPasses per lane) into the warp's
// sketch (rank r in lane r % 32, slot r / 32): the s smallest distinct
// values of both, by rounds of __reduce_min_sync that each take the
// smallest value left and clear every copy of it.
template <int kSlots>
__device__ __forceinline__ void merge_candidates(uint32_t (&cand)[kPasses],
                                                 uint32_t (&sk)[kSlots],
                                                 int& count,
                                                 uint32_t& largest, int s,
                                                 int lane) {
  uint32_t merged[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) merged[i] = kSentinel;
  int taken = 0;
  bool more = true;
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    for (int i = 0; i < 32 && more; ++i) {
      if (slot * 32 + i == s) {
        more = false;
        break;
      }
      uint32_t m = cand[0];
#pragma unroll
      for (int p = 1; p < kPasses; ++p) m = min(m, cand[p]);
#pragma unroll
      for (int j = 0; j < kSlots; ++j) m = min(m, sk[j]);
      m = __reduce_min_sync(kFull, m);
      if (m == kSentinel) {
        more = false;
        break;
      }
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
        if (cand[p] == m) cand[p] = kSentinel;
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        if (sk[j] == m) sk[j] = kSentinel;
      if (lane == i) merged[slot] = m;
      largest = m;
      ++taken;
    }
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) sk[i] = merged[i];
  count = taken;
}

// kSlots = ceil(s / 32) registers per lane hold the sketch.
template <int kSlots>
__global__ void __launch_bounds__(kWarps * 32)
    sketch_packed_kernel(const uint8_t* __restrict__ packed,
                         const uint8_t* __restrict__ ambig,
                         const int32_t* __restrict__ lens,
                         const int32_t* __restrict__ starts,
                         int64_t* __restrict__ out, int B, int P4, int P8,
                         int n_win, int k, int s, int W) {
  __shared__ uint32_t stage[kWarps][kPackedWords + kAmbigWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task =
      static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(B) * n_win) return;  // whole warps
  const int b = static_cast<int>(task / n_win);
  const int wi = static_cast<int>(task % n_win);
  const int start = starts[wi];
  // characters [start, start + wlen) of the read; past the packed row
  // everything counts as ambiguous padding
  int wlen = min(max(lens[b] - start, 0), W);
  wlen = min(wlen, max(P4 * 4 - start, 0));
  const int n_kmers = wlen - k + 1;
  const uint8_t* prow = packed + static_cast<size_t>(b) * P4;
  const uint8_t* arow = ambig + static_cast<size_t>(b) * P8;
  const uint32_t kmask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
  const uint32_t amask = (1u << k) - 1u;
  uint32_t* sp = stage[warp];
  uint32_t* sa = sp + kPackedWords;
  uint8_t* spb = reinterpret_cast<uint8_t*>(sp);
  uint8_t* sab = reinterpret_cast<uint8_t*>(sa);

  uint32_t sk[kSlots];  // rank r in lane r % 32, slot r / 32
#pragma unroll
  for (int i = 0; i < kSlots; ++i) sk[i] = kSentinel;
  int count = 0;                // values in the sketch
  uint32_t largest = kSentinel;  // its largest value once count == s

  for (int c0 = 0; c0 < n_kmers; c0 += kChunk) {
    const int first = start + c0;  // first character of the chunk
    const int pb0 = first >> 2, ab0 = first >> 3;
    __syncwarp();  // the previous chunk's reads of the stage are done
    for (int i = lane; i < kPackedWords * 4; i += 32)
      spb[i] = pb0 + i < P4 ? prow[pb0 + i] : 0;
    if (lane < kAmbigWords * 4)
      sab[lane] = ab0 + lane < P8 ? arow[ab0 + lane] : 0xFF;
    __syncwarp();

    uint32_t cand[kPasses];
    bool any = false;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int off = p * 32 + lane;  // k-mer start within the chunk
      uint32_t h = kSentinel;
      if (c0 + off < n_kmers) {
        h = staged_kmer_hash(sp, sa, (first & 3) + off, (first & 7) + off,
                             k, kmask, amask);
        if (count == s && h >= largest) h = kSentinel;
      }
      cand[p] = h;
      any |= h != kSentinel;
    }
    if (!__any_sync(kFull, any)) continue;
    merge_candidates<kSlots>(cand, sk, count, largest, s, lane);
  }

  int64_t* orow = out + (static_cast<size_t>(b) * n_win + wi) * s;
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    const int r = slot * 32 + lane;
    if (r < s) orow[r] = static_cast<int64_t>(sk[slot]);
  }
}

// 2-bit code of an ASCII base (A/a 0, C/c 1, G/g 2, T/t 3), 4 for any
// other byte (ambiguous); ops/encode.py's CHAR_LUT.
__device__ __forceinline__ uint32_t base_code(uint8_t ch) {
  const uint8_t c = ch | 0x20;  // lower case; only A and a map to 'a', ...
  return c == 'a' ? 0u : c == 'c' ? 1u : c == 'g' ? 2u : c == 't' ? 3u : 4u;
}

// The sixteen low bits of lo and hi interleaved: bit i of lo at bit 2i,
// bit i of hi at bit 2i + 1.
__device__ __forceinline__ uint32_t interleave16(uint32_t lo, uint32_t hi) {
  lo &= 0xFFFFu;
  hi &= 0xFFFFu;
  lo = (lo | (lo << 8)) & 0x00FF00FFu;
  hi = (hi | (hi << 8)) & 0x00FF00FFu;
  lo = (lo | (lo << 4)) & 0x0F0F0F0Fu;
  hi = (hi | (hi << 4)) & 0x0F0F0F0Fu;
  lo = (lo | (lo << 2)) & 0x33333333u;
  hi = (hi | (hi << 2)) & 0x33333333u;
  lo = (lo | (lo << 1)) & 0x55555555u;
  hi = (hi | (hi << 1)) & 0x55555555u;
  return lo | (hi << 1);
}

// The window sketch of the build: one warp per window of a batch of whole
// reference records. Window w of record r covers bytes
// [off[r] + w * stride, + min(W, len[r] - w * stride)) of seq (ASCII, as
// read); task t is window t - win_off[r] of the record r with
// win_off[r] <= t < win_off[r + 1]. Each chunk of the window is staged as
// the packed kernel stages its rows (2-bit words and ambiguity words, in
// shared memory), built from the ASCII bytes by three ballots per 32
// characters, so the k-mer hashes and the merge are the packed kernel's.
template <int kSlots>
__global__ void __launch_bounds__(kWarps * 32)
    sketch_windows_kernel(const uint8_t* __restrict__ seq,
                          const int64_t* __restrict__ rec_off,
                          const int64_t* __restrict__ rec_len,
                          const int64_t* __restrict__ win_off, int n_rec,
                          long long n_win, int k, int s, int W, int stride,
                          uint32_t* __restrict__ out) {
  // staged groups of 32 characters: a chunk's kChunk k-mer starts, the
  // last k-mer's 15 more characters and the funnel shifts' slack word
  constexpr int kGroups = kChunk / 32 + 1;
  __shared__ uint32_t stage[kWarps][3 * kGroups];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task =
      static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= n_win) return;  // whole warps
  int lo = 0, hi = n_rec - 1;  // the record: last r with win_off[r] <= task
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (win_off[mid] <= task) lo = mid; else hi = mid - 1;
  }
  const long long wstart = (task - win_off[lo]) * stride;
  const int wlen =
      static_cast<int>(min(static_cast<long long>(W), rec_len[lo] - wstart));
  const uint8_t* chars = seq + rec_off[lo] + wstart;
  const int n_kmers = wlen - k + 1;
  const uint32_t kmask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
  const uint32_t amask = (1u << k) - 1u;
  uint32_t* sp = stage[warp];           // 2 * kGroups packed words
  uint32_t* sa = sp + 2 * kGroups;      // kGroups ambiguity words

  uint32_t sk[kSlots];  // rank r in lane r % 32, slot r / 32
#pragma unroll
  for (int i = 0; i < kSlots; ++i) sk[i] = kSentinel;
  int count = 0;
  uint32_t largest = kSentinel;

  for (int c0 = 0; c0 < n_kmers; c0 += kChunk) {
    __syncwarp();  // the previous chunk's reads of the stage are done
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int i = c0 + g * 32 + lane;
      const uint32_t code = i < wlen ? base_code(chars[i]) : 4u;
      const uint32_t amb = __ballot_sync(kFull, code > 3);
      const uint32_t b0 = __ballot_sync(kFull, code & 1u);
      const uint32_t b1 = __ballot_sync(kFull, code & 2u);
      if (lane == 0) {
        sa[g] = amb;
        sp[2 * g] = interleave16(b0, b1);
        sp[2 * g + 1] = interleave16(b0 >> 16, b1 >> 16);
      }
    }
    __syncwarp();

    uint32_t cand[kPasses];
    bool any = false;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int off = p * 32 + lane;
      uint32_t h = kSentinel;
      if (c0 + off < n_kmers) {
        h = staged_kmer_hash(sp, sa, off, off, k, kmask, amask);
        if (count == s && h >= largest) h = kSentinel;
      }
      cand[p] = h;
      any |= h != kSentinel;
    }
    if (!__any_sync(kFull, any)) continue;
    merge_candidates<kSlots>(cand, sk, count, largest, s, lane);
  }

  uint32_t* orow = out + static_cast<size_t>(task) * s;
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    const int r = slot * 32 + lane;
    if (r < s) orow[r] = sk[slot];
  }
}

template <int kSlots>
cudaError_t launch(const void* packed, const void* ambig, const void* lens,
                   const void* starts, void* out, int B, int P4, int P8,
                   int n_win, int k, int s, int W, cudaStream_t stream) {
  const long long tasks = static_cast<long long>(B) * n_win;
  const long long blocks = (tasks + kWarps - 1) / kWarps;
  sketch_packed_kernel<kSlots><<<static_cast<unsigned>(blocks), kWarps * 32,
                                 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(ambig),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(starts),
      static_cast<int64_t*>(out), B, P4, P8, n_win, k, s, W);
  return cudaGetLastError();
}

}  // namespace

// packed [B, P4] u8, ambig [B, P8] u8, lens [B] i32, starts [n_win] i32
// (device pointers) -> out [B, n_win * s] i64. Returns a cudaError_t.
extern "C" int mc_sketch_packed(const void* packed, const void* ambig,
                                const void* lens, const void* starts,
                                void* out, int B, int P4, int P8, int n_win,
                                int k, int s, int W, void* stream) {
  if (k < 1 || k > 16 || s < 1 || s > kMaxSketch || P8 * 2 != P4 || B < 0 ||
      n_win < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * n_win == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 32)
    return static_cast<int>(launch<1>(packed, ambig, lens, starts, out, B,
                                      P4, P8, n_win, k, s, W, st));
  if (s <= 64)
    return static_cast<int>(launch<2>(packed, ambig, lens, starts, out, B,
                                      P4, P8, n_win, k, s, W, st));
  return static_cast<int>(launch<8>(packed, ambig, lens, starts, out, B, P4,
                                    P8, n_win, k, s, W, st));
}

namespace {

template <int kSlots>
cudaError_t launch_windows(const void* seq, const void* rec_off,
                           const void* rec_len, const void* win_off,
                           int n_rec, long long n_win, int k, int s, int W,
                           int stride, void* out, cudaStream_t stream) {
  const long long blocks = (n_win + kWarps - 1) / kWarps;
  sketch_windows_kernel<kSlots><<<static_cast<unsigned>(blocks), kWarps * 32,
                                  0, stream>>>(
      static_cast<const uint8_t*>(seq), static_cast<const int64_t*>(rec_off),
      static_cast<const int64_t*>(rec_len),
      static_cast<const int64_t*>(win_off), n_rec, n_win, k, s, W, stride,
      static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// seq [bytes] u8 (ASCII), rec_off / rec_len [n_rec] i64, win_off
// [n_rec + 1] i64 (window prefix counts; win_off[n_rec] = n_win), all
// device pointers -> out [n_win, s] u32 (each window's sketch ascending,
// padded with 0xFFFFFFFF). Returns a cudaError_t.
extern "C" int mc_sketch_windows(const void* seq, const void* rec_off,
                                 const void* rec_len, const void* win_off,
                                 int n_rec, long long n_win, int k, int s,
                                 int W, int stride, void* out,
                                 void* stream) {
  if (k < 1 || k > 16 || s < 1 || s > kMaxSketch || W < 1 || stride < 1 ||
      n_rec < 0 || n_win < 0 || (n_win > 0 && n_rec == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_win == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 32)
    return static_cast<int>(launch_windows<1>(seq, rec_off, rec_len, win_off,
                                              n_rec, n_win, k, s, W, stride,
                                              out, st));
  if (s <= 64)
    return static_cast<int>(launch_windows<2>(seq, rec_off, rec_len, win_off,
                                              n_rec, n_win, k, s, W, stride,
                                              out, st));
  return static_cast<int>(launch_windows<8>(seq, rec_off, rec_len, win_off,
                                            n_rec, n_win, k, s, W, stride,
                                            out, st));
}

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
// Plain C interface, bound with ctypes (metacache_tpu_torch/ops/
// sketch_cuda.py, built by ops/cuda_build.py). The launcher returns
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
        const int ua = (first & 7) + off;
        const uint32_t amb =
            __funnelshift_r(sa[ua >> 5], sa[(ua >> 5) + 1], ua & 31);
        if ((amb & amask) == 0) {
          const int u = (first & 3) + off;
          // character i of the k-mer at bits 2i
          const uint32_t x =
              __funnelshift_r(sp[u >> 4], sp[(u >> 4) + 1], 2 * (u & 15)) &
              kmask;
          // the k-mer with its first character highest
          // (src/dna_encoding.h), and its reverse complement
          const uint32_t fwd = reverse_groups(x) >> (32 - 2 * k);
          const uint32_t rc = ~x & kmask;
          h = tm_hash(min(fwd, rc));
          if (count == s && h >= largest) h = kSentinel;
        }
      }
      cand[p] = h;
      any |= h != kSentinel;
    }
    if (!__any_sync(kFull, any)) continue;

    // merge: the s smallest distinct values of sketch and candidates
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

  int64_t* orow = out + (static_cast<size_t>(b) * n_win + wi) * s;
#pragma unroll
  for (int slot = 0; slot < kSlots; ++slot) {
    const int r = slot * 32 + lane;
    if (r < s) orow[r] = static_cast<int64_t>(sk[slot]);
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

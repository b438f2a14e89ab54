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
// sketch. Unlike the Pallas kernel it takes any 1 <= k <= 16, any B and
// sketch sizes up to kMaxSketchLarge: sizes up to kMaxSketch (the default
// 16 and everything the native host sketcher takes) run an instantiation
// with a 64-entry buffer, larger ones one with a 256-entry buffer, so the
// common case keeps its small per-thread footprint.
//
// What bounds it on the card: integer ALU work. A 100 bp read arrives as
// ~26 bytes of 2-bit codes (+13 bytes of ambiguity bits) and costs ~100
// rolling k-mer updates, reverse complements, hashes and sorted-buffer
// inserts, so memory traffic is negligible next to the integer
// instructions. The design is the simple right one: one thread per
// (read, window) rolls the k-mer over the packed bytes (no unpacked
// intermediate in device memory, as in the Pallas kernel) and keeps the
// reference's sorted insertion buffer in a per-thread array. The Pallas
// kernel's phase-major packed-word assembly existed only because Mosaic
// has no lane shuffles; it is not carried over. Making this fast (more
// threads per read, warp-level selection, registers instead of local
// memory for the buffer) is later work.
//
// Plain C interface, bound with ctypes (metacache_tpu_torch/ops/
// sketch_cuda.py, built by ops/cuda_build.py). The launcher returns
// cudaGetLastError() after the launch; the caller allocates every buffer.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSketch = 64;
constexpr int kMaxSketchLarge = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t tm_hash(uint32_t x) {
  x = ((x >> 16) ^ x) * 0x45D9F3Bu;
  x = ((x >> 16) ^ x) * 0x45D9F3Bu;
  return (x >> 16) ^ x;
}

// Reverse complement of a 2-bit packed k-mer (src/dna_encoding.h:113-121).
__device__ __forceinline__ uint32_t revcomp(uint32_t s, int k) {
  s = ((s >> 2) & 0x33333333u) | ((s & 0x33333333u) << 2);
  s = ((s >> 4) & 0x0F0F0F0Fu) | ((s & 0x0F0F0F0Fu) << 4);
  s = ((s >> 8) & 0x00FF00FFu) | ((s & 0x00FF00FFu) << 8);
  s = (s >> 16) | (s << 16);
  return (~s) >> (32 - 2 * k);
}

template <int kMax>
__global__ void sketch_packed_kernel(const uint8_t* __restrict__ packed,
                                     const uint8_t* __restrict__ ambig,
                                     const int32_t* __restrict__ lens,
                                     const int32_t* __restrict__ starts,
                                     int64_t* __restrict__ out, int B, int P4,
                                     int P8, int n_win, int k, int s, int W) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(B) * n_win) return;
  const int b = static_cast<int>(tid / n_win);
  const int wi = static_cast<int>(tid % n_win);
  const int start = starts[wi];
  // characters [start, start + wlen) of the read; past the packed row
  // everything counts as ambiguous padding
  int wlen = min(max(lens[b] - start, 0), W);
  wlen = min(wlen, max(P4 * 4 - start, 0));
  const uint8_t* prow = packed + static_cast<size_t>(b) * P4;
  const uint8_t* arow = ambig + static_cast<size_t>(b) * P8;
  const uint32_t mask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;

  uint32_t sk[kMax];  // ascending, distinct
  int cnt = 0;
  uint32_t kmer = 0;
  int clean = 0;  // unambiguous characters ending at the current one
  for (int i = 0; i < wlen; ++i) {
    const int p = start + i;
    const uint32_t c = (prow[p >> 2] >> (2 * (p & 3))) & 3u;
    const bool amb = (arow[p >> 3] >> (p & 7)) & 1u;
    kmer = ((kmer << 2) | c) & mask;
    clean = amb ? 0 : clean + 1;
    if (clean < k) continue;
    const uint32_t h = tm_hash(min(kmer, revcomp(kmer, k)));
    if (h == kSentinel || (cnt == s && h >= sk[s - 1])) continue;
    int pos = cnt;
    while (pos > 0 && sk[pos - 1] > h) --pos;
    if (pos > 0 && sk[pos - 1] == h) continue;  // already in the sketch
    for (int j = cnt < s ? cnt : s - 1; j > pos; --j) sk[j] = sk[j - 1];
    sk[pos] = h;
    if (cnt < s) ++cnt;
  }
  int64_t* orow = out + (static_cast<size_t>(b) * n_win + wi) * s;
  for (int j = 0; j < s; ++j)
    orow[j] = j < cnt ? static_cast<int64_t>(sk[j])
                      : static_cast<int64_t>(kSentinel);
}

}  // namespace

// packed [B, P4] u8, ambig [B, P8] u8, lens [B] i32, starts [n_win] i32
// (device pointers) -> out [B, n_win * s] i64. Returns a cudaError_t.
extern "C" int mc_sketch_packed(const void* packed, const void* ambig,
                                const void* lens, const void* starts,
                                void* out, int B, int P4, int P8, int n_win,
                                int k, int s, int W, void* stream) {
  if (k < 1 || k > 16 || s < 1 || s > kMaxSketchLarge || P8 * 2 != P4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * n_win;
  if (total == 0) return 0;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  auto kernel = s <= kMaxSketch ? sketch_packed_kernel<kMaxSketch>
                                : sketch_packed_kernel<kMaxSketchLarge>;
  kernel<<<static_cast<unsigned>(blocks), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(ambig),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(starts),
      static_cast<int64_t*>(out), B, P4, P8, n_win, k, s, W);
  return static_cast<int>(cudaGetLastError());
}

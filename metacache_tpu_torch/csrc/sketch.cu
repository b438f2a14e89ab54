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
// same per-window function, in place of the host's native sketcher. At
// the build's shape (k 16, s 16, window 128, stride 113 = W - k + 1) a
// launch holds ~221,000 adjacent windows of one 25 Mbp record, and each
// k-mer start belongs to exactly one window. Its bytes are the records'
// (~1 byte a k-mer start) and its output; its operations are the k-mer
// work, so it is bound by operations (~64 lane operations a window).
// The first design ran the read kernel's code, one warp per
// window, and took ~1,440 warp issue slots a window (4.4% of the bound):
// the merge's s serial rounds of __reduce_min_sync, each yielding one
// value for all 32 lanes; staging by ballots whose interleave lane 0 ran
// alone, every window encoding again the k - 1 characters it shares with
// the next; and 15 of 128 k-mer slots idle. Redesigned, a block
// of up to 128 windows (sketch_span_kernel):
//   - stages its windows' span of the records once: the 16-byte chunks
//     the windows cover (consecutive windows of a record share them, so
//     the build's windows load ~14.5 kB of one span), eight chunks per
//     thread with their uint4 loads in flight together, encoded in
//     registers by byte-wise arithmetic (2-bit codes and ambiguity bits
//     of 16 characters in ~90 operations, every thread busy) into
//     shared memory;
//   - gives each thread one window. It rolls each character into both
//     strands once (two shifts and a funnel shift) and hashes each
//     k-mer once; validity for 16 k-mers at a time comes from one smear
//     of their ambiguity bits, applied as a mask, not a branch;
//   - selects without branches: each batch of 16 hashes is sorted by a
//     60-comparator network and merged into the kCap kept values (16,
//     32 or 64 >= s, sorted in registers) by the lower half of a
//     bitonic merge, ~120 min/max operations a batch. Inserting hash by
//     hash cost more: the warp ran the 31-operation insert whenever one
//     of its 32 lanes kept a hash, on nearly every k-mer. The merge
//     keeps equal hashes (a k-mer repeated in the window) as often as
//     they occur; a window whose kept values are not all distinct is
//     redone hash by hash, dropping a hash equal to a kept one;
//   - writes the block's sketches through shared memory, so the stores
//     of consecutive windows' rows coalesce.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at the config-3 build's
// first batch shape (scripts/window_parts.py, PERF.md): staging and
// output ~0.015 ms, the strands and hashes ~0.027 ms, the selection
// ~0.024 ms, 0.067 ms in all (the first design: 0.305 ms).
// Sketch sizes over 64, and windows too long for a block's staging room
// (W over 65,536 characters), keep the first design
// (sketch_windows_kernel, one warp per window).
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

// The window sketch of the build, first design, kept for sketch
// sizes over 64 and windows too long for a span block: one warp per
// window of a batch of whole reference records. Window w of record r
// covers bytes [off[r] + w * stride, + min(W, len[r] - w * stride)) of
// seq (ASCII, as read); task t is window t - win_off[r] of the record r
// with win_off[r] <= t < win_off[r + 1]. Each chunk of the window is
// staged as the packed kernel stages its rows (2-bit words and ambiguity
// words, in shared memory), built from the ASCII bytes by three ballots
// per 32 characters, so the k-mer hashes and the merge are the packed
// kernel's.
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

// ---- the build's windows, a block per span of the records ----

constexpr int kSpanThreads = 128;  // threads a block, one window each
constexpr int kStaged = 8;         // chunks a thread loads at once
// shared memory a block may take without an opt-in
constexpr int kSpanSmem = 48 * 1024;

// Where each of a span block's shared arrays starts, in bytes, for nw
// windows of at most W characters and sketch size s: per window its
// first and one-past-last 16-byte chunk (u64 each); the first chunk of
// a run; per window the end of its staged chunks (i32); the warps'
// totals; then one region that holds the staged chunks (packed words
// and ambiguity half-words) and, once they are read, the block's
// sketches (rows of s + 1 words: no bank conflicts).
struct SpanLayout {
  int chunks;  // staged 16-byte chunks at most: each window's own
  int ca, cb, run, end, warp, packed, ambig, rows, bytes;
  __host__ __device__ SpanLayout(int nw, int W, int s) {
    chunks = nw * ((W + 30) / 16);
    ca = 0;
    cb = ca + 8 * nw;
    run = cb + 8 * nw;
    end = run + 8;
    warp = end + 4 * nw;
    packed = (warp + 4 * (kSpanThreads / 32) + 15) & ~15;
    ambig = packed + 4 * (chunks + 2);
    rows = packed;
    const int stage = ambig + 2 * (chunks + 4);
    const int out = rows + 4 * nw * (s + 1);
    bytes = stage > out ? stage : out;
  }
};

// The 2-bit codes (character i at bits 2i) and ambiguity bits (bit i) of
// the 16 ASCII characters in v, by byte-wise arithmetic in registers:
// per byte, (lower case >> 1) & 3 is 0 1 3 2 for a c g t, an xor of its
// high bit into its low bit makes it 0 1 2 3, and the byte is a base
// exactly when it equals the letter of that code (ops/encode.py's
// CHAR_LUT).
__device__ __forceinline__ void encode_chunk(uint4 v, uint32_t& packed,
                                             uint32_t& amb) {
  const uint32_t word[4] = {v.x, v.y, v.z, v.w};
  packed = 0;
  amb = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t c = word[q] | 0x20202020u;
    uint32_t x = (c >> 1) & 0x03030303u;
    x ^= (x >> 1) & 0x01010101u;
    // each byte's code as the nibble selector of its letter in "acgt"
    const uint32_t y = x | (x >> 4);
    const uint32_t sel = (y & 0xFFu) | ((y >> 8) & 0xFF00u);
    const uint32_t d = c ^ __byte_perm(0x74676361u, 0, sel);
    const uint32_t nonzero =
        (((d & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | d) & 0x80808080u;
    // one bit (amb) or two (codes) of each byte gathered by a multiply
    amb |= ((((nonzero >> 7) * 0x01020408u) >> 24) & 0xFu) << (4 * q);
    packed |= ((x * 0x01041040u) >> 24) << (8 * q);
  }
}

// Bit q of the result: a bit of a is set among bits q .. q + k - 1 (for
// q + k <= 32).
__device__ __forceinline__ uint32_t any_in_span(uint32_t a, int k) {
  int w = 1;  // a's bit q covers bits [q, q + w)
  for (; 2 * w <= k; w *= 2) a |= a >> w;
  return w < k ? a | (a >> (k - w)) : a;
}

__device__ __forceinline__ void compare_exchange(uint32_t& a, uint32_t& b) {
  const uint32_t x = a;
  a = min(x, b);
  b = max(x, b);
}

// Sorts v ascending: a 60-comparator network of depth 10 (one layer a
// line; it sorts all 2^16 inputs of zeros and ones, so by the 0-1
// principle it sorts any input), every index fixed, so v stays in
// registers.
__device__ __forceinline__ void sort16(uint32_t (&v)[16]) {
#define MC_CE(a, b) compare_exchange(v[a], v[b]);
  MC_CE(0, 13) MC_CE(1, 12) MC_CE(2, 15) MC_CE(3, 14) MC_CE(4, 8)
  MC_CE(5, 6) MC_CE(7, 11) MC_CE(9, 10)
  MC_CE(0, 5) MC_CE(1, 7) MC_CE(2, 9) MC_CE(3, 4) MC_CE(6, 13)
  MC_CE(8, 14) MC_CE(10, 15) MC_CE(11, 12)
  MC_CE(0, 1) MC_CE(2, 3) MC_CE(4, 5) MC_CE(6, 8) MC_CE(7, 9)
  MC_CE(10, 11) MC_CE(12, 13) MC_CE(14, 15)
  MC_CE(0, 2) MC_CE(1, 3) MC_CE(4, 10) MC_CE(5, 11) MC_CE(6, 7)
  MC_CE(8, 9) MC_CE(12, 14) MC_CE(13, 15)
  MC_CE(1, 2) MC_CE(3, 12) MC_CE(4, 6) MC_CE(5, 7) MC_CE(8, 10)
  MC_CE(9, 11) MC_CE(13, 14)
  MC_CE(1, 4) MC_CE(2, 6) MC_CE(5, 8) MC_CE(7, 10) MC_CE(9, 13)
  MC_CE(11, 14)
  MC_CE(2, 4) MC_CE(3, 6) MC_CE(9, 12) MC_CE(11, 13)
  MC_CE(3, 5) MC_CE(6, 8) MC_CE(7, 9) MC_CE(10, 12)
  MC_CE(3, 4) MC_CE(5, 6) MC_CE(7, 8) MC_CE(9, 10) MC_CE(11, 12)
  MC_CE(6, 7) MC_CE(8, 9)
#undef MC_CE
}

// The kCap smallest hashes of the window whose first character is
// staged character u0, ascending in sk (padded with kSentinel). Its
// first k-mer by funnel shifts; then 16 k-mers a batch: each rolls one
// character into both strands (16 characters taken from the staged
// words at once), and their validity comes from one smear of the
// batch's ambiguity bits, applied without a branch. kExact inserts
// each hash into sk by a min/max network unless a kept value equals it
// (the kCap smallest distinct hashes). Otherwise the batch is sorted by
// a network and merged into sk (the kCap smallest with multiplicity,
// which equals the exact result whenever the kept values come out
// pairwise distinct): no branch, where inserting would run the network
// for every k-mer that some lane of the warp keeps.
template <int kCap, bool kExact>
__device__ __forceinline__ void sketch_window(const uint32_t* sp,
                                              const uint32_t* sa, int u0,
                                              int n_kmers, int k,
                                              uint32_t (&sk)[kCap]) {
  const uint32_t kmask = k == 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
  const uint32_t amask = (1u << k) - 1u;
  const int down = 32 - 2 * k;
  auto keep = [&](uint32_t h) {
    if (h < sk[kCap - 1]) {  // the sentinel never passes
      bool dup = false;
      if (kExact) {
#pragma unroll
        for (int r = 0; r < kCap - 1; ++r) dup |= sk[r] == h;
      }
      if (!dup) {
#pragma unroll
        for (int r = kCap - 1; r > 0; --r)
          sk[r] = min(sk[r], max(sk[r - 1], h));
        sk[0] = min(sk[0], h);
      }
    }
  };
  const uint32_t x =
      __funnelshift_r(sp[u0 >> 4], sp[(u0 >> 4) + 1], 2 * (u0 & 15)) &
      kmask;
  uint32_t fwd = reverse_groups(x) >> down;
  uint32_t rct = ~x << down;
  const uint32_t amb0 =
      __funnelshift_r(sa[u0 >> 5], sa[(u0 >> 5) + 1], u0 & 31) & amask;
  keep(amb0 ? kSentinel : tm_hash(min(fwd, rct >> down)));
  // k-mer i > 0 rolls in character i + k - 1
  for (int i = 1; i < n_kmers; i += 16) {
    const int v = u0 + i + k - 1, va = u0 + i;
    const uint32_t codes =
        __funnelshift_r(sp[v >> 4], sp[(v >> 4) + 1], 2 * (v & 15));
    // bit q: k-mer i + q touches an ambiguous character or lies past
    // the window
    uint32_t bad = any_in_span(
        __funnelshift_r(sa[va >> 5], sa[(va >> 5) + 1], va & 31), k);
    if (n_kmers - i < 16) bad |= ~0u << (n_kmers - i);
    // the complements enter the reverse strand at its top: rct is rc
    // shifted up to bit 31, a funnel shift a character
    const uint32_t ncodes = ~codes;
    uint32_t h[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      fwd = ((fwd << 2) & kmask) | ((codes >> (2 * q)) & 3u);
      rct = __funnelshift_r(rct, ncodes >> (2 * q), 2);
      // all ones (the sentinel) where the k-mer is not valid
      const uint32_t invalid = 0u - ((bad >> q) & 1u);
      h[q] = tm_hash(min(fwd, rct >> down)) | invalid;
    }
    if (kExact) {
#pragma unroll
      for (int q = 0; q < 16; ++q) keep(h[q]);
    } else {
      sort16(h);
      // the lower half of a bitonic merge of sk with the batch (padded
      // with sentinels to kCap): bitonic, and the kCap smallest
#pragma unroll
      for (int q = 0; q < 16; ++q)
        sk[kCap - 16 + q] = min(sk[kCap - 16 + q], h[15 - q]);
#pragma unroll
      for (int stride = kCap >> 1; stride > 0; stride >>= 1) {
#pragma unroll
        for (int r = 0; r < kCap; ++r)
          if ((r ^ stride) > r) compare_exchange(sk[r], sk[r ^ stride]);
      }
    }
  }
}

// The build's window sketch, a block per run of nw consecutive windows
// (tasks) of a batch of whole records (window w of record r as in
// sketch_windows_kernel). The block stages every 16-byte chunk of seq
// that its windows cover, once: each window's chunk range [ca, cb)
// either extends the previous window's (the same record, adjacent or
// overlapping) or starts a run of its own, so a block-wide prefix sum
// gives every chunk its place and every window its first chunk. Then
// thread j sketches window j alone, its sketch sorted in kCap >= s
// registers, and the block writes its nw rows of s values at once.
template <int kCap>
__global__ void __launch_bounds__(kSpanThreads)
    sketch_span_kernel(const uint8_t* __restrict__ seq,
                       const int64_t* __restrict__ rec_off,
                       const int64_t* __restrict__ rec_len,
                       const int64_t* __restrict__ win_off, int n_rec,
                       long long n_win, int k, int s, int W, int stride,
                       int nw, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const SpanLayout lay(nw, W, s);
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  unsigned long long* s_ca =
      reinterpret_cast<unsigned long long*>(base + lay.ca);
  unsigned long long* s_cb =
      reinterpret_cast<unsigned long long*>(base + lay.cb);
  unsigned long long* s_run =
      reinterpret_cast<unsigned long long*>(base + lay.run);
  int* s_end = reinterpret_cast<int*>(base + lay.end);
  int* s_warp = reinterpret_cast<int*>(base + lay.warp);
  uint32_t* sp = reinterpret_cast<uint32_t*>(base + lay.packed);
  uint16_t* sa16 = reinterpret_cast<uint16_t*>(base + lay.ambig);
  const uint32_t* sa = reinterpret_cast<const uint32_t*>(sa16);
  uint32_t* rows = reinterpret_cast<uint32_t*>(base + lay.rows);
  constexpr unsigned long long kNone = ~0ull;

  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const long long t0 = static_cast<long long>(blockIdx.x) * nw;
  const bool mine = j < nw && t0 + j < n_win;
  const uintptr_t seq_addr = reinterpret_cast<uintptr_t>(seq);
  // this thread's window: its first character (an address) and length
  uintptr_t first = 0;
  int wlen = 0;
  if (mine) {
    const long long task = t0 + j;
    int lo = 0, hi = n_rec - 1;  // the last r with win_off[r] <= task
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (win_off[mid] <= task) lo = mid; else hi = mid - 1;
    }
    const long long wstart = (task - win_off[lo]) * stride;
    wlen = static_cast<int>(
        min(static_cast<long long>(W), rec_len[lo] - wstart));
    first = seq_addr + rec_off[lo] + wstart;
  }
  const int n_kmers = wlen - k + 1;
  // the window's 16-byte chunks; a window without a k-mer needs none
  unsigned long long ca = kNone, cb = kNone;
  if (n_kmers > 0) {
    ca = first >> 4;
    cb = (first + wlen + 15) >> 4;
  }
  if (j < nw) {
    s_ca[j] = ca;
    s_cb[j] = cb;
  }
  __syncthreads();
  int added = 0;  // the chunks this window adds to the staged runs
  bool starts_run = false;
  if (n_kmers > 0) {
    const unsigned long long pa = j > 0 ? s_ca[j - 1] : kNone;
    const unsigned long long pb = j > 0 ? s_cb[j - 1] : kNone;
    const bool extend = pa != kNone && pa <= ca && ca <= pb && pb <= cb;
    added = static_cast<int>(extend ? cb - pb : cb - ca);
    starts_run = !extend;
    if (starts_run) *s_run = ca;  // read only where one window starts one
  }
  // block-wide inclusive prefix sum of `added`
  int end = added;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, end, d);
    if (lane >= d) end += v;
  }
  if (lane == 31) s_warp[warp] = end;
  const int runs = __syncthreads_count(starts_run);
  int total = 0;
#pragma unroll
  for (int w = 0; w < kSpanThreads / 32; ++w) {
    const int v = s_warp[w];
    if (w < warp) end += v;
    total += v;
  }
  if (j < nw) s_end[j] = end;
  __syncthreads();

  // stage kStaged chunks a thread at a time, their loads all in flight:
  // chunk c is the one run's chunk c, or it belongs to the first window
  // whose end passes it
  const unsigned long long run0 = *s_run;
  for (int c0 = 0; c0 < total; c0 += kSpanThreads * kStaged) {
    uint4 v[kStaged];
#pragma unroll
    for (int u = 0; u < kStaged; ++u) {
      const int c = c0 + u * kSpanThreads + j;
      if (c < total) {
        unsigned long long chunk = run0 + c;
        if (runs != 1) {
          int lo = 0, hi = nw - 1;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_end[mid] > c) hi = mid; else lo = mid + 1;
          }
          chunk = s_cb[lo] - static_cast<unsigned long long>(s_end[lo] - c);
        }
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            static_cast<uintptr_t>(chunk << 4)));
      }
    }
#pragma unroll
    for (int u = 0; u < kStaged; ++u) {
      const int c = c0 + u * kSpanThreads + j;
      if (c < total) {
        uint32_t packed, amb;
        encode_chunk(v[u], packed, amb);
        sp[c] = packed;
        sa16[c] = static_cast<uint16_t>(amb);
      }
    }
  }
  __syncthreads();

  uint32_t sk[kCap];  // the kCap smallest distinct hashes, ascending
#pragma unroll
  for (int r = 0; r < kCap; ++r) sk[r] = kSentinel;
  if (n_kmers > 0) {
    // staged place of the window's first character
    const int u0 = (end - static_cast<int>(cb - ca)) * 16 +
                   static_cast<int>(first & 15);
    sketch_window<kCap, false>(sp, sa, u0, n_kmers, k, sk);
    // equal kept values (a k-mer repeated in the window): redo exactly
    bool dup = false;
#pragma unroll
    for (int r = 0; r < kCap - 1; ++r)
      dup |= sk[r] == sk[r + 1] && sk[r] != kSentinel;
    if (dup) {
#pragma unroll
      for (int r = 0; r < kCap; ++r) sk[r] = kSentinel;
      sketch_window<kCap, true>(sp, sa, u0, n_kmers, k, sk);
    }
  }
  __syncthreads();  // every staged word is read: the rows take the region
  if (mine) {
#pragma unroll
    for (int r = 0; r < kCap; ++r)
      if (r < s) rows[j * (s + 1) + r] = sk[r];
  }
  __syncthreads();
  const long long n_rows = min(static_cast<long long>(nw), n_win - t0);
  const int n_out = static_cast<int>(n_rows) * s;
  uint32_t* orow = out + static_cast<size_t>(t0) * s;
  // element e = j + m kSpanThreads of the rows: (row, col) advanced by
  // (drow, dcol) a step, no division in the loop
  const int drow = kSpanThreads / s, dcol = kSpanThreads - drow * s;
  int row = j / s, col = j - row * s;
  for (int e = j; e < n_out; e += kSpanThreads) {
    orow[e] = rows[row * (s + 1) + col];
    row += drow;
    col += dcol;
    if (col >= s) {
      col -= s;
      ++row;
    }
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

// Windows a span block takes for window length W and sketch size s: 128,
// or fewer where their staging room would pass kSpanSmem; 0 if even one
// window's does.
int span_windows(int W, int s) {
  if (W > 64 * 1024) return 0;
  int nw = kSpanThreads;
  while (nw > 0 && SpanLayout(nw, W, s).bytes > kSpanSmem) --nw;
  return nw;
}

template <int kCap>
cudaError_t launch_span(const void* seq, const void* rec_off,
                        const void* rec_len, const void* win_off, int n_rec,
                        long long n_win, int k, int s, int W, int stride,
                        int nw, void* out, cudaStream_t stream) {
  const long long blocks = (n_win + nw - 1) / nw;
  sketch_span_kernel<kCap><<<static_cast<unsigned>(blocks), kSpanThreads,
                             SpanLayout(nw, W, s).bytes, stream>>>(
      static_cast<const uint8_t*>(seq), static_cast<const int64_t*>(rec_off),
      static_cast<const int64_t*>(rec_len),
      static_cast<const int64_t*>(win_off), n_rec, n_win, k, s, W, stride,
      nw, static_cast<uint32_t*>(out));
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
  const int nw = s <= 64 ? span_windows(W, s) : 0;
  if (nw > 0) {
    if (s <= 16)
      return static_cast<int>(launch_span<16>(seq, rec_off, rec_len, win_off,
                                              n_rec, n_win, k, s, W, stride,
                                              nw, out, st));
    if (s <= 32)
      return static_cast<int>(launch_span<32>(seq, rec_off, rec_len, win_off,
                                              n_rec, n_win, k, s, W, stride,
                                              nw, out, st));
    return static_cast<int>(launch_span<64>(seq, rec_off, rec_len, win_off,
                                            n_rec, n_win, k, s, W, stride, nw,
                                            out, st));
  }
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

// Merge of P sorted shard feature tables into one fused table, one chunk
// of the key space at a time, hand-written for Hopper (sm_90a).
//
// Each shard holds a CSR table: sorted unique keys (u32), offsets (i64)
// and per location a target and a window (i32), every bucket sorted by
// (target, window). A chunk is the slice of every shard whose keys lie in
// one key range [K_c, K_c+1) (query/upload.py plans the ranges), laid end
// to end in shard order:
//   keys [NK]   the shards' key slices (u32 bits)
//   offs [NK+P] each shard's offsets slice, one entry past its last key
//               (absolute offsets into that shard's locations)
//   tgt, win    [NL] the shards' location slices
//   bounds      [2, P+1] i64: where each shard's keys (row 0) and
//               locations (row 1) start in the arrays above
//
// mc_merge_locations: the chunk's locations in the fused order, (key,
// target, window) ascending, equal triples in shard order: the order of
// the host merge mcio_merge_shard_tables (native/mcio.cpp), location for
// location. It writes the packed location (target << 32 | window) into
// the engine's final location table and the key beside it; the caller
// turns key run starts into the chunk's fused keys and offsets. Buckets
// left empty are skipped, as the host merge skips them.
//
// What bounds it on the card: device-memory bytes, 20 per location (tgt,
// win read; an 8-byte location and a 4-byte key written) and 12 per key.
// The first design gave each location a thread that found its
// output place by binary searches: its own shard's offsets for its key,
// then every other shard's keys and that shard's bucket, ~45-50
// dependent loads a location, repeated by neighbours that share a key;
// at config-3's first chunk (16.8 M locations, ~7.6 M keys: ~90 MB of
// keys and offsets, more than the 50 MB L2) their lower levels went to
// device memory, and it reached 14% of the bound. Redesigned as
// a merge path over tiles of the output (the GPU merge-path partition),
// three kernels per call, all counted as the call's one launch:
//   1. expand_keys_kernel, one thread per key: writes the key of every
//      location of its bucket into a scratch array (4 bytes a location),
//      so that a location's key is one load;
//   2. merge_partition_kernel, one thread per tile of kTile output
//      positions: one binary search on the merge's diagonal through its
//      tile's first position gives how many of the tile's predecessors
//      come from the left input, comparing (key, target, window) triples
//      read straight from the arrays, ties to the left;
//   3. merge_tiles_kernel, one block per tile: loads its slices of both
//      inputs once, coalesced, into shared memory; each thread finds its
//      kItems outputs' split by a second diagonal search there and merges
//      them serially; the block writes its tile back contiguously.
// Two shards (the config-3 query) take one round of 2 and 3. P > 2 runs
// ceil(log2 P) rounds of the same two-way merge over neighbouring groups
// of shards (left group first on ties: the lower shards), through
// scratch arrays; the last round writes the outputs. The scratch (the
// partition, the expanded keys and, for P > 2, two sets of round
// outputs) is allocated by the caller: mc_merge_scratch_bytes says how
// much. Bytes moved: 12 per key and 4 per location (1), 12 read and 12
// written per location and round (3), against the bound's 12 and 20.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W on config-3's first
// chunk (chip_smoke.py, PERF.md): 0.293 ms, 43.6% of its 0.1275 ms
// bound (the first design: 0.900 ms).
//
// mc_merge_count_keys: the chunk's keys that no lower shard holds (all of
// shard 0's, and each higher shard's keys absent from the shards before
// it). Summed over the chunks it sizes the fused key table before
// anything else is allocated. What bounds it: device-memory bytes, 4 per
// key read. The first design gave each key a thread that binary-searched
// every lower shard's keys: ~22 dependent loads a key, repeated by
// neighbours that share the upper levels; 0.180 ms on the seeded
// config-3 chunk, 5.1% of the bound. Redesigned as co-ranked tiles
// (merge_count_keys_kernel, one kernel for every P): a block takes tiles
// of 2,048 keys of shards 1..P-1, 8 a thread, loaded coalesced; per
// lower shard two warp-wide 32-way searches (~6 dependent loads, not
// ~22) find the range of that shard's keys between the tile's first and
// last key, and the block stages the range in shared memory, coalesced,
// 4,096 keys at a time (a denser lower shard takes several pieces),
// padded to a power of two so that each thread looks its keys up by a
// branch-free search of 11-12 steps, each one load at a constant
// offset, a compare and a select. For P = 2 every key of the chunk is
// read about once. One atomic per block; no scratch. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W on the seeded chunk (chip_smoke.py
// --kernel-times, PERF.md): 0.0204 ms, 44.6% of its 0.00908 ms bound.
// What holds it there: each block takes two or three tiles one after the
// other, each behind its searches' dependent loads, and the lookups'
// 12 shared-memory steps a key.
//
// There is no TPU kernel to replace: the JAX package merges shards on the
// host (metacache_tpu/native/mcio.cpp, mcio_merge_shard_tables), as the
// port did before this kernel.
//
// Plain C interface, bound with ctypes (metacache_tpu_torch/ops/
// merge_cuda.py, built by ops/cuda_build.py). Each launcher returns
// cudaGetLastError() after its launches; the caller allocates every
// buffer.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The shard s with beg[s] <= i < beg[s + 1] (i < beg[P]).
__device__ __forceinline__ int shard_of(const long long* beg, long long i) {
  int s = 0;
  while (beg[s + 1] <= i) ++s;
  return s;
}

// ---- the location merge: expand, partition, merge tiles ----

constexpr int kTile = 2048;           // output positions a merge block takes
constexpr int kMergeThreads = 256;
constexpr int kItems = kTile / kMergeThreads;  // outputs a thread merges
// shared arrays hold element e at e + e / 32, so that both a thread's
// kItems consecutive elements and 32 consecutive ones fall in 32 banks
constexpr int kSkewed = kTile + kTile / 32;

__device__ __forceinline__ int skew(int e) { return e + (e >> 5); }

// Location i of shard s goes to scratch position lbeg[s] + i: every
// location of key j's bucket gets key j.
__global__ void __launch_bounds__(kThreads)
    expand_keys_kernel(const unsigned* __restrict__ keys,
                       const long long* __restrict__ offs,
                       const long long* __restrict__ bounds, int P,
                       long long nk, unsigned* __restrict__ lockey) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= nk) return;
  const long long* kbeg = bounds;
  const long long* lbeg = bounds + P + 1;
  const int s = shard_of(kbeg, i);
  const long long* os = offs + kbeg[s] + s;
  const long long j = i - kbeg[s];
  const long long base = lbeg[s] - __ldg(os);
  const unsigned k = __ldg(keys + i);
  const long long to = base + __ldg(os + j + 1);
  for (long long p = base + __ldg(os + j); p < to; ++p) lockey[p] = k;
}

// One round's pair g: its left input [ps, pm) (the shards
// [2 g hw, 2 g hw + hw)) and its right input [pm, pe) (the next hw).
struct Pair {
  long long ps, pm, pe;
};

__device__ __forceinline__ Pair pair_at(const long long* lbeg, int P,
                                        int hw, int g) {
  const int s0 = 2 * g * hw;
  return {lbeg[min(s0, P)], lbeg[min(s0 + hw, P)], lbeg[min(s0 + 2 * hw, P)]};
}

// (key, target, window) of a: does it come before b, or tie with it?
__device__ __forceinline__ bool not_after(unsigned ka, int ta, int wa,
                                          unsigned kb, int tb, int wb) {
  return ka < kb || (ka == kb && (ta < tb || (ta == tb && wa <= wb)));
}

// How many of the first `diag` outputs of the pair's merge come from its
// left input (ties to the left).
__device__ long long split_global(const unsigned* __restrict__ key,
                                  const int* __restrict__ tgt,
                                  const int* __restrict__ win, Pair q,
                                  long long diag) {
  const long long nb = q.pe - q.pm;
  long long lo = max(0ll, diag - nb), hi = min(diag, q.pm - q.ps);
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long a = q.ps + mid, b = q.pm + diag - 1 - mid;
    if (not_after(__ldg(key + a), __ldg(tgt + a), __ldg(win + a),
                  __ldg(key + b), __ldg(tgt + b), __ldg(win + b)))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// part[b]: the split of tile b's first position in the pair holding it.
__global__ void __launch_bounds__(kThreads)
    merge_partition_kernel(const unsigned* __restrict__ key,
                           const int* __restrict__ tgt,
                           const int* __restrict__ win,
                           const long long* __restrict__ bounds, int P,
                           int hw, long long tiles,
                           long long* __restrict__ part) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b >= tiles) return;
  const long long* lbeg = bounds + P + 1;
  const long long d = b * kTile;
  int g = 0;
  Pair q = pair_at(lbeg, P, hw, 0);
  while (q.pe <= d) q = pair_at(lbeg, P, hw, ++g);
  part[b] = split_global(key, tgt, win, q, d - q.ps);
}

// Tile b: output positions [b kTile, (b + 1) kTile) of every pair of the
// round that holds some of them. Writes (key, target, window) arrays,
// or, in the last round, the packed locations and their keys.
template <bool kLast>
__global__ void __launch_bounds__(kMergeThreads)
    merge_tiles_kernel(const unsigned* __restrict__ key,
                       const int* __restrict__ tgt,
                       const int* __restrict__ win,
                       const long long* __restrict__ bounds, int P, int hw,
                       long long nl, const long long* __restrict__ part,
                       unsigned* __restrict__ okey, int* __restrict__ otgt,
                       int* __restrict__ owin,
                       long long* __restrict__ out_loc) {
  __shared__ unsigned sk[kSkewed];
  __shared__ int st[kSkewed], sw[kSkewed];
  const long long* lbeg = bounds + P + 1;
  const int tid = threadIdx.x;
  const long long d0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long d1 = min(d0 + kTile, nl);
  const int pairs = (P + 2 * hw - 1) / (2 * hw);
  for (int g = 0; g < pairs; ++g) {
    const Pair q = pair_at(lbeg, P, hw, g);
    if (q.pe <= d0 || q.ps >= d1) continue;
    const long long ds = max(d0, q.ps) - q.ps, de = min(d1, q.pe) - q.ps;
    const long long a0 = q.ps >= d0 ? 0 : part[blockIdx.x];
    const long long a1 = q.pe <= d1 ? q.pm - q.ps : part[blockIdx.x + 1];
    const long long b0 = ds - a0;
    const int na = static_cast<int>(a1 - a0);
    const int n = static_cast<int>(de - ds);
    const int nb = n - na;
    __syncthreads();  // the last pair's tile is written out
    for (int e = tid; e < n; e += kMergeThreads) {
      const long long src = e < na ? q.ps + a0 + e : q.pm + b0 + (e - na);
      sk[skew(e)] = __ldg(key + src);
      st[skew(e)] = __ldg(tgt + src);
      sw[skew(e)] = __ldg(win + src);
    }
    __syncthreads();
    // this thread's outputs [x0, x0 + cnt) of the tile: left elements
    // [0, na), right [na, n) in the shared arrays
    const int x0 = min(tid * kItems, n);
    const int cnt = min(kItems, n - x0);
    int lo = max(0, x0 - nb), hi = min(x0, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int a = skew(mid), b = skew(na + x0 - 1 - mid);
      if (not_after(sk[a], st[a], sw[a], sk[b], st[b], sw[b]))
        lo = mid + 1;
      else
        hi = mid;
    }
    int ia = lo, ib = x0 - lo;
    unsigned rk[kItems];
    int rt[kItems], rw[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (r < cnt) {
        const int a = skew(ia), b = skew(na + ib);
        const bool left =
            ib >= nb ||
            (ia < na && not_after(sk[a], st[a], sw[a], sk[b], st[b], sw[b]));
        const int c = left ? a : b;
        rk[r] = sk[c];
        rt[r] = st[c];
        rw[r] = sw[c];
        ia += left;
        ib += !left;
      }
    }
    __syncthreads();  // every thread has read its inputs
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (r < cnt) {
        const int c = skew(x0 + r);
        sk[c] = rk[r];
        st[c] = rt[r];
        sw[c] = rw[r];
      }
    }
    __syncthreads();
    const long long at = q.ps + ds;
    for (int e = tid; e < n; e += kMergeThreads) {
      const int c = skew(e);
      if (kLast) {
        out_loc[at + e] =
            static_cast<long long>(
                static_cast<unsigned long long>(static_cast<long long>(st[c]))
                << 32) |
            static_cast<long long>(sw[c]);
        okey[at + e] = sk[c];
      } else {
        okey[at + e] = sk[c];
        otgt[at + e] = st[c];
        owin[at + e] = sw[c];
      }
    }
  }
}

// The rounds a merge of P shards takes (at least one: it also moves a
// single shard's locations into place).
int merge_rounds(int P) {
  int r = 1;
  while ((1 << r) < P) ++r;
  return r;
}

long long round_up(long long bytes) { return (bytes + 255) & ~255ll; }

// ---- the key count: co-ranked tiles over the higher shards ----

constexpr int kCountThreads = 256;
constexpr int kCountItems = 8;  // keys of its tile a thread holds
constexpr int kCountTile = kCountThreads * kCountItems;
constexpr int kPiece = 2 * kCountTile;  // keys of a lower shard staged at once

// First j in [lo, hi) with keys[j] > k (strict) or keys[j] >= k (u32
// order), else hi. Called by a whole warp: each step probes 32 evenly
// spaced keys and keeps the slice where the answer lies, so ~22 dependent
// loads become ~5; every lane returns the answer.
__device__ __forceinline__ long long warp_search(
    const unsigned* __restrict__ keys, long long lo, long long hi, unsigned k,
    bool strict) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long len = hi - lo;
    const unsigned v = __ldg(keys + lo + len * (lane + 1) / 32 - 1);
    const unsigned past =
        __ballot_sync(0xffffffffu, strict ? v > k : v >= k);
    if (!past) return hi;
    const int f = __ffs(past) - 1;
    hi = lo + len * (f + 1) / 32 - 1;  // a key past k: the answer <= hi
    lo += len * f / 32;
  }
  const bool in = lo + lane < hi;
  const unsigned v = in ? __ldg(keys + lo + lane) : 0u;
  const unsigned past =
      __ballot_sync(0xffffffffu, in && (strict ? v > k : v >= k));
  return past ? lo + __ffs(past) - 1 : hi;
}

// Per key, the last position in piece[0, W) whose key is <= it (0 if
// none is): a branch-free binary search of log2(W) steps, each one load
// at a constant offset, a compare and a select. W is a power of two.
template <int W>
__device__ __forceinline__ void last_not_above(const unsigned* piece,
                                               const unsigned (&k)[kCountItems],
                                               int (&at)[kCountItems]) {
#pragma unroll
  for (int i = 0; i < kCountItems; ++i) at[i] = 0;
#pragma unroll
  for (int half = W / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int i = 0; i < kCountItems; ++i)
      at[i] += piece[at[i] + half] <= k[i] ? half : 0;
  }
}

// Tiles of kCountTile keys over the keys of shards 1..P-1 (the keys from
// kbeg[1] on), taken by the blocks in turn. A tile's segment of shard s
// (a tile may straddle shards) counts its keys that no shard r < s holds:
// per r, two warp searches give the range of r's keys between the
// segment's first and last key, and the block stages that range through
// shared memory kPiece keys at a time, padded to a power of two with
// copies of its last key, where each thread searches its keys. Block 0
// also counts shard 0's keys, which all count.
__global__ void __launch_bounds__(kCountThreads)
    merge_count_keys_kernel(const unsigned* __restrict__ keys,
                            const long long* __restrict__ kbeg, int P,
                            long long nk,
                            unsigned long long* __restrict__ count) {
  __shared__ unsigned piece[kPiece];
  __shared__ long long range[2];
  __shared__ unsigned warp_sums[kCountThreads / 32];
  const int tid = threadIdx.x, warp = tid >> 5;
  unsigned n = 0;  // this thread's keys that count
  for (long long t0 = kbeg[1] + static_cast<long long>(blockIdx.x) *
                                    kCountTile;
       t0 < nk; t0 += static_cast<long long>(gridDim.x) * kCountTile) {
    const long long t1 = min(t0 + kCountTile, nk);
    int s = 1;
    while (kbeg[s + 1] <= t0) ++s;
    for (; s < P && kbeg[s] < t1; ++s) {
      const long long a = max(t0, kbeg[s]), e = min(t1, kbeg[s + 1]);
      if (a >= e) continue;
      // item i: key a + tid + i kCountThreads; bit i of `held`: a lower
      // shard holds it, or it lies past the segment
      unsigned k[kCountItems];
      unsigned held = 0;
#pragma unroll
      for (int i = 0; i < kCountItems; ++i) {
        const long long p = a + tid + i * kCountThreads;
        k[i] = p < e ? __ldg(keys + p) : 0u;
        held |= static_cast<unsigned>(p >= e) << i;
      }
      for (int r = 0; r < s; ++r) {
        if (warp < 2) {
          const long long j = warp_search(
              keys, kbeg[r], kbeg[r + 1], __ldg(keys + (warp ? e - 1 : a)),
              warp == 1);
          if ((tid & 31) == 0) range[warp] = j;
        }
        __syncthreads();
        const long long lo = range[0], hi = range[1];
        __syncthreads();  // read before the next search writes them
        for (long long p0 = lo; p0 < hi; p0 += kPiece) {
          const int len = static_cast<int>(min(hi - p0, 1ll * kPiece));
          const int width = len <= kPiece / 2 ? kPiece / 2 : kPiece;
          for (int x = tid; x < width; x += kCountThreads)
            piece[x] = __ldg(keys + p0 + min(x, len - 1));
          __syncthreads();
          // a staged key equals k exactly when the piece holds k
          int at[kCountItems];
          if (width == kPiece)
            last_not_above<kPiece>(piece, k, at);
          else
            last_not_above<kPiece / 2>(piece, k, at);
#pragma unroll
          for (int i = 0; i < kCountItems; ++i)
            held |= static_cast<unsigned>(piece[at[i]] == k[i]) << i;
          __syncthreads();  // the piece is read
        }
      }
      n += kCountItems - __popc(held);
    }
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((tid & 31) == 0) warp_sums[warp] = n;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total =
        blockIdx.x == 0 ? static_cast<unsigned long long>(kbeg[1] - kbeg[0])
                        : 0ull;
    for (int w = 0; w < kCountThreads / 32; ++w) total += warp_sums[w];
    if (total) atomicAdd(count, total);
  }
}

}  // namespace

// Bytes of scratch that mc_merge_locations needs for P shards and nl
// locations: the partition, the expanded keys and, for P > 2, two sets
// of (key, target, window) arrays for the rounds' outputs.
extern "C" long long mc_merge_scratch_bytes(int P, long long nl) {
  const long long tiles = (nl + kTile - 1) / kTile;
  return round_up(8 * tiles) + round_up(4 * nl) * (P > 2 ? 6 : 1);
}

// keys [NK] u32, offs [NK+P] i64, tgt / win [NL] i32, bounds [2, P+1] i64
// and scratch of mc_merge_scratch_bytes(P, nl) bytes (device pointers) ->
// out_loc [NL] i64 (the chunk's slice of the final location table) and
// out_key [NL] i32 (u32 bits). Returns a cudaError_t.
extern "C" int mc_merge_locations(const void* keys, const void* offs,
                                  const void* tgt, const void* win,
                                  const void* bounds, int P, long long nk,
                                  long long nl, void* out_loc, void* out_key,
                                  void* scratch, void* stream) {
  if (P < 1 || nk < 0 || nl < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nl == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* bnd = static_cast<const long long*>(bounds);
  const long long tiles = (nl + kTile - 1) / kTile;
  char* at = static_cast<char*>(scratch);
  long long* part = reinterpret_cast<long long*>(at);
  at += round_up(8 * tiles);
  // the round outputs: set 0 reuses the expanded keys once read
  unsigned* rkey[2] = {nullptr, nullptr};
  int* rtgt[2] = {nullptr, nullptr};
  int* rwin[2] = {nullptr, nullptr};
  for (int i = 0; i < (P > 2 ? 6 : 1); ++i) {
    int* a = reinterpret_cast<int*>(at);
    at += round_up(4 * nl);
    if (i % 3 == 0) rkey[i / 3] = reinterpret_cast<unsigned*>(a);
    else if (i % 3 == 1) rtgt[i / 3] = a;
    else rwin[i / 3] = a;
  }
  if (nk > 0) {
    expand_keys_kernel<<<static_cast<unsigned>((nk + kThreads - 1) /
                                               kThreads),
                         kThreads, 0, st>>>(
        static_cast<const unsigned*>(keys),
        static_cast<const long long*>(offs), bnd, P, nk, rkey[0]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned* ik = rkey[0];
  const int* it = static_cast<const int*>(tgt);
  const int* iw = static_cast<const int*>(win);
  const int rounds = merge_rounds(P);
  for (int r = 0; r < rounds; ++r) {
    const int hw = 1 << r;
    merge_partition_kernel<<<static_cast<unsigned>((tiles + kThreads - 1) /
                                                   kThreads),
                             kThreads, 0, st>>>(ik, it, iw, bnd, P, hw,
                                                tiles, part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (r == rounds - 1) {
      merge_tiles_kernel<true><<<static_cast<unsigned>(tiles), kMergeThreads,
                                 0, st>>>(
          ik, it, iw, bnd, P, hw, nl, part,
          static_cast<unsigned*>(out_key), nullptr, nullptr,
          static_cast<long long*>(out_loc));
    } else {
      const int o = (r + 1) % 2;  // round 0 writes set 1, round 1 set 0
      merge_tiles_kernel<false><<<static_cast<unsigned>(tiles),
                                  kMergeThreads, 0, st>>>(
          ik, it, iw, bnd, P, hw, nl, part, rkey[o], rtgt[o], rwin[o],
          nullptr);
      ik = rkey[o];
      it = rtgt[o];
      iw = rwin[o];
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// keys [NK] u32, kbeg [P+1] i64 -> *count += the keys of the chunk that no
// lower shard holds (count: one u64 on the card). Returns a cudaError_t.
extern "C" int mc_merge_count_keys(const void* keys, const void* kbeg, int P,
                                   long long nk, void* count, void* stream) {
  if (P < 1 || nk < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nk == 0) return 0;
  // as many blocks as the card holds at once (found once), or one per
  // tile of the chunk's keys where that is fewer
  static const int resident = [] {
    int dev = 0, sms = 132, per = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, merge_count_keys_kernel, kCountThreads, 0);
    return sms * (per > 0 ? per : 1);
  }();
  const long long tiles = (nk + kCountTile - 1) / kCountTile;
  merge_count_keys_kernel<<<static_cast<unsigned>(
                                tiles < resident ? tiles : resident),
                            kCountThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(keys), static_cast<const long long*>(kbeg),
      P, nk, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

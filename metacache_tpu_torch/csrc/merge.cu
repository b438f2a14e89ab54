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
// mc_merge_locations: one thread per location, by rank. Location i of
// shard s, with key k, target t and window w, goes to the chunk-local
// position i + sum over the other shards r of rank_r(k, t, w), where
// rank_r counts r's locations that sort before it in (key, target,
// window) order: a binary search for k in r's keys gives every location
// of smaller keys (r's offsets at that key), then a binary search on
// (target, window) inside r's bucket of k. Equal triples go to the lower
// shard first (shard r < s counts <=, r > s counts <), which is the tie
// rule of the host merge mcio_merge_shard_tables (native/mcio.cpp), so the
// result is that merge's, location for location. The thread writes the
// packed location (target << 32 | window) into the engine's final
// location table and the key beside it; the caller turns key run starts
// into the chunk's fused keys and offsets. Buckets left empty are
// skipped, as the host merge skips them.
//
// mc_merge_count_keys: the same searches in count mode, one thread per key:
// a key counts unless a lower shard holds it too. Summed over the chunks
// it sizes the fused key table before anything else is allocated.
//
// There is no TPU kernel to replace: the JAX package merges shards on the
// host (metacache_tpu/native/mcio.cpp, mcio_merge_shard_tables), as the
// port did before this kernel.
//
// What bounds it on the card: device-memory bytes, 20 per location (tgt,
// win read; an 8-byte location and a 4-byte key written) and 12 per key.
// Each thread makes (P - 1) dependent binary searches, ~20 steps in a
// chunk's keys and ~8 in a bucket; a chunk's key slices (a few MB) stay
// in the 50 MB L2, so the searches are latency-bound loads from L2.
//
// Plain C interface, bound with ctypes (metacache_tpu_torch/ops/
// merge_cuda.py, built by ops/cuda_build.py). Each launcher returns
// cudaGetLastError() after the launch; the caller allocates every buffer.
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

// First j in [0, n) with keys[j] >= k, or n.
__device__ __forceinline__ long long lower_bound(
    const unsigned* __restrict__ keys, long long n, unsigned k) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    merge_locations_kernel(const unsigned* __restrict__ keys,
                           const long long* __restrict__ offs,
                           const int* __restrict__ tgt,
                           const int* __restrict__ win,
                           const long long* __restrict__ bounds, int P,
                           long long nl, long long* __restrict__ out_loc,
                           int* __restrict__ out_key) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= nl) return;
  const long long* kbeg = bounds;
  const long long* lbeg = bounds + P + 1;
  const int s = shard_of(lbeg, i);
  const long long li = i - lbeg[s];
  // own bucket: the first j whose bucket ends past this location (empty
  // buckets end where they start, so they are passed over)
  const unsigned* ks = keys + kbeg[s];
  const long long* os = offs + kbeg[s] + s;
  const long long x = os[0] + li;
  long long lo = 0, hi = kbeg[s + 1] - kbeg[s];
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(os + mid + 1) <= x) lo = mid + 1;
    else hi = mid;
  }
  const unsigned k = __ldg(ks + lo);
  const int t = __ldg(tgt + i);
  const int w = __ldg(win + i);
  long long pos = li;
  for (int r = 0; r < P; ++r) {
    if (r == s) continue;
    const unsigned* kr = keys + kbeg[r];
    const long long nkr = kbeg[r + 1] - kbeg[r];
    const long long* orr = offs + kbeg[r] + r;
    const long long j = lower_bound(kr, nkr, k);
    long long before = __ldg(orr + j) - __ldg(orr);
    if (j < nkr && __ldg(kr + j) == k) {
      const int* tr = tgt + lbeg[r] + before;
      const int* wr = win + lbeg[r] + before;
      long long a = 0, b = __ldg(orr + j + 1) - __ldg(orr + j);
      const bool ties_before = r < s;
      while (a < b) {
        const long long m = (a + b) >> 1;
        const int tm = __ldg(tr + m);
        const int wm = __ldg(wr + m);
        if (tm < t || (tm == t && (wm < w || (ties_before && wm == w))))
          a = m + 1;
        else
          b = m;
      }
      before += a;
    }
    pos += before;
  }
  out_loc[pos] = static_cast<long long>(
                     static_cast<unsigned long long>(static_cast<long long>(t))
                     << 32) |
                 static_cast<long long>(w);
  out_key[pos] = static_cast<int>(k);
}

__global__ void __launch_bounds__(kThreads)
    merge_count_keys_kernel(const unsigned* __restrict__ keys,
                            const long long* __restrict__ kbeg, int P,
                            long long nk,
                            unsigned long long* __restrict__ count) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  bool first = i < nk;
  if (first) {
    const int s = shard_of(kbeg, i);
    const unsigned k = __ldg(keys + i);
    for (int r = 0; r < s && first; ++r) {
      const unsigned* kr = keys + kbeg[r];
      const long long nkr = kbeg[r + 1] - kbeg[r];
      const long long j = lower_bound(kr, nkr, k);
      first = !(j < nkr && __ldg(kr + j) == k);
    }
  }
  const unsigned votes = __ballot_sync(0xffffffffu, first);
  if ((threadIdx.x & 31) == 0 && votes)
    atomicAdd(count, static_cast<unsigned long long>(__popc(votes)));
}

}  // namespace

// keys [NK] u32, offs [NK+P] i64, tgt / win [NL] i32, bounds [2, P+1] i64
// (device pointers) -> out_loc [NL] i64 (the chunk's slice of the final
// location table) and out_key [NL] i32 (u32 bits). Returns a cudaError_t.
extern "C" int mc_merge_locations(const void* keys, const void* offs,
                                  const void* tgt, const void* win,
                                  const void* bounds, int P, long long nl,
                                  void* out_loc, void* out_key,
                                  void* stream) {
  if (P < 1 || nl < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nl == 0) return 0;
  const long long blocks = (nl + kThreads - 1) / kThreads;
  merge_locations_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(keys), static_cast<const long long*>(offs),
      static_cast<const int*>(tgt), static_cast<const int*>(win),
      static_cast<const long long*>(bounds), P, nl,
      static_cast<long long*>(out_loc), static_cast<int*>(out_key));
  return static_cast<int>(cudaGetLastError());
}

// keys [NK] u32, kbeg [P+1] i64 -> *count += the keys of the chunk that no
// lower shard holds (count: one u64 on the card). Returns a cudaError_t.
extern "C" int mc_merge_count_keys(const void* keys, const void* kbeg, int P,
                                   long long nk, void* count, void* stream) {
  if (P < 1 || nk < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nk == 0) return 0;
  const long long blocks = (nk + kThreads - 1) / kThreads;
  merge_count_keys_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(keys), static_cast<const long long*>(kbeg),
      P, nk, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

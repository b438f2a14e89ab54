// Row-limited table gather, hand-written for Hopper (sm_90a):
//
//   out[b, j] = table[idx[b, j]]   if j < n_valid[b]
//             = pad                otherwise
//
// Replaces the two Pallas TPU gather probes of tools/exp_pallas_gather.py:
// `k1` (a flat dynamic gather, out = table[idx], the case n_valid == L)
// and `k2` (the same gather with the table laid out as [N/128, 128] rows
// plus a lane pick). k2's row-and-lane layout existed only because Mosaic
// had no flat dynamic gather; on Hopper a flat gather is native, so one
// kernel serves both. In the port it is the lookup's scattered CSR
// location fetch (ops/lookup.py), the operation those probes were written
// to replace.
//
// What bounds it on the card: device-memory latency and sector traffic.
// Every valid slot reads one table word from a random place (a 32-byte
// sector for 4 or 8 useful bytes) in a table far larger than the 50 MB
// L2 at config-2 scale (696 MB), so the kernel is a latency-bound stream
// of independent loads. The design keeps it that: one thread per output
// element, coalesced reads of idx and writes of out, table loads through
// the read-only path (__ldg), and no load at all for slots past n_valid
// (a row holds on average far fewer matches than its capacity). Fusing
// the slot expansion that computes idx into this kernel is later work.
//
// Contract: the index of every slot below n_valid[b] lies in [0, N); the
// lookup builds them in range, and the kernel does not check them. Slots
// at or past n_valid[b] are never read, so their index may be anything.
//
// Plain C interface, bound with ctypes (metacache_tpu_torch/ops/
// gather_cuda.py, built by ops/cuda_build.py). Each launcher returns
// cudaGetLastError() after the launch; the caller allocates every buffer.
#include <cuda_runtime.h>

namespace {

// 64-bit values are `long long` (not int64_t, which is `long` here) so
// that __ldg resolves to its long long overload.
template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table,
                                   const long long* __restrict__ idx,
                                   const long long* __restrict__ n_valid,
                                   T* __restrict__ out, long long total,
                                   int L, T pad) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += stride) {
    const long long b = e / L;
    const int j = static_cast<int>(e - b * L);
    out[e] = j < __ldg(n_valid + b) ? __ldg(table + __ldg(idx + e)) : pad;
  }
}

template <typename T>
int launch(const void* table, const void* idx, const void* n_valid,
           void* out, long long B, int L, T pad, void* stream) {
  if (B < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = B * L;
  if (total == 0) return 0;
  const int threads = 256;
  // enough blocks to fill the card many times over; the grid-stride loop
  // covers the rest
  const long long want = (total + threads - 1) / threads;
  const long long blocks = want < 132 * 64 ? want : 132 * 64;
  gather_rows_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const long long*>(idx),
      static_cast<const long long*>(n_valid), static_cast<T*>(out), total,
      L, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [N] i32, idx [B, L] i64, n_valid [B] i64 (device pointers)
// -> out [B, L] i32. Returns a cudaError_t.
extern "C" int mc_gather_rows_i32(const void* table, const void* idx,
                                  const void* n_valid, void* out,
                                  long long B, int L, int pad,
                                  void* stream) {
  return launch<int>(table, idx, n_valid, out, B, L, pad, stream);
}

// The same with an i64 table and output (the port's packed locations).
extern "C" int mc_gather_rows_i64(const void* table, const void* idx,
                                  const void* n_valid, void* out,
                                  long long B, int L, long long pad,
                                  void* stream) {
  return launch<long long>(table, idx, n_valid, out, B, L, pad, stream);
}

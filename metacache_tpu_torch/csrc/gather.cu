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
// What bounds it on the card: device-memory bytes. At config-2's lookup
// shape the [16384, 256] int64 output (33.5 MB) is most of them; only
// ~5% of the slots are valid, each reading its index and one 32-byte
// sector of a table far larger than the 50 MB L2 (696 MB), a latency-
// bound stream of independent loads. The design:
//   - rows, not flat elements: a group of G lanes (G a power of two up to
//     32, a whole warp unless the row is short) walks one row, reading
//     n_valid[b] once, with no 64-bit division per element;
//   - memory-level parallelism on the valid prefix: each lane first
//     stores its vectors that lie wholly past n_valid, then issues the
//     idx loads of the others, then their table loads, then stores them,
//     so up to kUnroll * V loads of each kind are in flight per lane and
//     the pad stores do not wait for them; slots past n_valid load
//     nothing;
//   - 16-byte stores (V = 16 / sizeof(T) elements) when a row's length
//     keeps every row 16-byte aligned, one element per store otherwise,
//     so the pad tail, most of the output, leaves as wide stores.
// Fusing the slot expansion that computes idx into this kernel is later
// work.
//
// Contract: the index of every slot below n_valid[b] lies in [0, N); the
// lookup builds them in range, and the kernel does not check them. Slots
// at or past n_valid[b] are never read, so their index may be anything.
//
// Plain C interface, bound with ctypes (metacache_tpu_torch/ops/
// gather_cuda.py, built by ops/cuda_build.py). Each launcher returns
// cudaGetLastError() after the launch; the caller allocates every buffer.
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors per lane in flight

// V values of T as one store: 16 bytes, or a single element.
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const T (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    int4 w;
    memcpy(&w, v, 16);
    *reinterpret_cast<int4*>(p) = w;
  }
}

// 64-bit values are `long long` (not int64_t, which is `long` here) so
// that __ldg resolves to its long long overload.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const T* __restrict__ table,
                       const long long* __restrict__ idx,
                       const long long* __restrict__ n_valid,
                       T* __restrict__ out, long long B, int L, int G,
                       T pad) {
  // G divides 32, so a group never straddles two warps
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (row >= B) return;
  const int g = threadIdx.x & (G - 1);
  const long long nv_row = __ldg(n_valid + row);
  const int nv = static_cast<int>(nv_row < 0 ? 0 : nv_row < L ? nv_row : L);
  const long long* irow = idx + row * L;
  T* orow = out + row * L;
  const int n_vec = L / V;
  for (int q0 = g; q0 < n_vec; q0 += G * kUnroll) {
    // vectors wholly past n_valid first: the store stream starts without
    // waiting for the loads of the valid prefix
    T pads[V];
#pragma unroll
    for (int e = 0; e < V; ++e) pads[e] = pad;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * G;
      if (q < n_vec && q * V >= nv) store<T, V>(orow + q * V, pads);
    }
    long long id[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = (q0 + u * G) * V + e;
        id[u][e] = j < nv ? __ldg(irow + j) : 0;
      }
    T val[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = (q0 + u * G) * V + e;
        val[u][e] = j < nv ? __ldg(table + id[u][e]) : pad;
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * G;
      if (q < n_vec && q * V < nv) store<T, V>(orow + q * V, val[u]);
    }
  }
}

template <typename T>
int launch(const void* table, const void* idx, const void* n_valid,
           void* out, long long B, int L, T pad, void* stream) {
  if (B < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B * L == 0) return 0;
  constexpr int kV = 16 / sizeof(T);
  const bool wide = L % kV == 0;
  const int n_vec = wide ? L / kV : L;
  int G = 1;  // lanes per row: enough for one vector each, at most a warp
  while (G < 32 && G < n_vec) G *= 2;
  const long long blocks = (B * G + kThreads - 1) / kThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const T*>(table);
  const auto* i = static_cast<const long long*>(idx);
  const auto* n = static_cast<const long long*>(n_valid);
  auto* o = static_cast<T*>(out);
  if (wide)
    gather_rows_kernel<T, kV><<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(t, i, n, o, B, L, G, pad);
  else
    gather_rows_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(t, i, n, o, B, L, G, pad);
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

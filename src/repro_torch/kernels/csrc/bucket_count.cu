// Bucket count: the cumulative counts #(x < b_j), j = 0..T, and #(x == b_T)
// of a float32 value stream against fixed histogram boundaries.
//
// Replaces `bucket_count_kernel` (src/repro/kernels/bucket_count.py:35,
// wrapper `cumulative_counts_pallas`), which compares every staged tile of
// the stream against all T+1 boundaries at once — n·(T+1) compares, cheap
// on the TPU's vector unit — and accumulates float32 partial counts across
// its sequential grid.  Here each element does one binary search over the
// boundaries instead (log2(T+1) compares): p = #(b_j <= x) over the sorted
// non-NaN prefix of the boundaries, so that x < b_j  <=>  p <= j.  A block
// keeps a histogram of p in shared memory (32-bit, one block never sees 2^32
// values), adds it once into a global 64-bit histogram, and one final block
// scans that histogram into the cumulative counts.  Counts are integers
// throughout: exact at any stream length, where the reference's float32
// sums stop being exact above 2^24.
//
// Semantics are IEEE compares, as the reference's: NaN values are never
// counted (they compare false), -0 == +0, and +inf counts in the last slot
// when b_T = +inf.  NaN boundaries (a partition that held NaN) end the
// boundary vector; x < NaN is false, so their slots count 0 and the search
// covers only the prefix before them (m boundaries, given by the wrapper,
// which also rejects unsorted boundaries).  The stream is never padded, so
// nothing but the n real values is counted.
//
// Bound: device-memory bytes, 4n to read the stream once (the boundaries
// and the counts are a few KB); the searches are log2(T+1) shared-memory
// loads per value.  Boundaries beyond what shared memory holds are searched
// in global memory (L2-resident) and counted with global atomics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kFinishThreads = 1024;
constexpr size_t kMaxShared = 232448;  // 227 KB a block on Hopper

// #(b_j <= v) for sorted b[0..m)
__device__ __forceinline__ int upper_bound(const float* b, int m, float v) {
  int lo = 0, len = m;
  while (len > 0) {
    int half = len >> 1;
    if (b[lo + half] <= v) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

// hist has m + 2 slots: slot p = #values with #(b_j <= v) = p (0..m), slot
// m + 1 = #(v == b_T) (only when b_T is not NaN, i.e. m == T + 1)
template <bool kShared>
__global__ void count_kernel(const float* __restrict__ x, long long n,
                             const float* __restrict__ b, int m, int has_last,
                             unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned char smem[];
  const float* bs = b;
  unsigned int* hs = nullptr;
  if (kShared) {
    float* sb = reinterpret_cast<float*>(smem);
    hs = reinterpret_cast<unsigned int*>(sb + m);
    for (int i = threadIdx.x; i < m; i += blockDim.x) sb[i] = b[i];
    for (int i = threadIdx.x; i < m + 2; i += blockDim.x) hs[i] = 0u;
    __syncthreads();
    bs = sb;
  }
  const float last = has_last ? bs[m - 1] : 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = x[i];
    if (v != v) continue;  // NaN: compares false with every boundary
    int p = upper_bound(bs, m, v);
    bool eq = has_last && p == m && v == last;
    if (kShared) {
      atomicAdd(&hs[p], 1u);
      if (eq) atomicAdd(&hs[m + 1], 1u);
    } else {
      atomicAdd(&hist[p], 1ull);
      if (eq) atomicAdd(&hist[m + 1], 1ull);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < m + 2; i += blockDim.x) {
      unsigned int c = hs[i];
      if (c) atomicAdd(&hist[i], (unsigned long long)c);
    }
  }
}

// out[j] = hist[0] + ... + hist[j] for j < m, 0 for m <= j <= T (NaN
// boundaries), out[T+1] = #(v == b_T).  One block, chunks of 1,024 slots
// with a carried total.
__global__ void finish_kernel(const unsigned long long* __restrict__ hist,
                              int m, int T1, int has_last,
                              long long* __restrict__ out) {
  __shared__ unsigned long long warp_tot[kFinishThreads / 32];
  __shared__ unsigned long long chunk_tot;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long carry = 0;
  for (int base = 0; base < m; base += blockDim.x) {
    int j = base + threadIdx.x;
    unsigned long long v = j < m ? hist[j] : 0ull;
    for (int d = 1; d < 32; d <<= 1) {
      unsigned long long up = __shfl_up_sync(0xFFFFFFFFu, v, d);
      if (lane >= (unsigned)d) v += up;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      unsigned long long w = lane < blockDim.x / 32 ? warp_tot[lane] : 0ull;
      for (int d = 1; d < 32; d <<= 1) {
        unsigned long long up = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= (unsigned)d) w += up;
      }
      warp_tot[lane] = w;  // inclusive over warps
      if (lane == 31) chunk_tot = w;
    }
    __syncthreads();
    if (warp > 0) v += warp_tot[warp - 1];
    if (j < m) out[j] = (long long)(carry + v);
    carry += chunk_tot;
    __syncthreads();  // warp_tot / chunk_tot reused by the next chunk
  }
  for (int j = m + threadIdx.x; j < T1; j += blockDim.x) out[j] = 0;
  if (threadIdx.x == 0) out[T1] = has_last ? (long long)hist[m + 1] : 0;
}

}  // namespace

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n,) float32; b (T1,) float32 whose first m entries are non-decreasing
// and the rest NaN; hist (m + 2,) uint64 scratch; out (T1 + 1,) int64.
// n may be 0: then only the final pass runs (it writes zeros).
int hk_bucket_count(const float* x, long long n, const float* b, int T1, int m,
                    unsigned long long* hist, long long* out, int sms,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int has_last = m == T1;
  cudaError_t err =
      cudaMemsetAsync(hist, 0, sizeof(unsigned long long) * (size_t)(m + 2), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    long long cap = (long long)sms * (2048 / kThreads);
    // keep each block's 32-bit shared counts below 2^32
    long long least = (n >> 31) + 1;
    if (blocks > cap) blocks = cap > least ? cap : least;
    size_t smem = sizeof(float) * (size_t)m + sizeof(unsigned int) * (size_t)(m + 2);
    if (smem <= kMaxShared) {
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(count_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
      count_kernel<true><<<(unsigned)blocks, kThreads, smem, st>>>(
          x, n, b, m, has_last, hist);
    } else {
      count_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
          x, n, b, m, has_last, hist);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finish_kernel<<<1, kFinishThreads, 0, st>>>(hist, m, T1, has_last, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

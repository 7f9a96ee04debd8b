// Batched histogram merge (paper Algorithm 1): the scan and the cuts.
//
// Replaces `merge_cut_kernel` (src/repro/kernels/merge_cut.py:46, wrapper
// `merge_pallas`), which fuses sort → prefix sum → cut count → gathers on
// one VMEM-resident problem.  Here a batch of Q problems runs in three
// steps: the stable kv sort of kv_sort.cu (hk_argsort) orders each
// problem's k(T+1) boundaries; `scan_kernel` (one block per problem,
// looping over 1,024-key chunks and carrying the running total) writes the
// left-collapse cumulative masses; `cut_kernel` (one thread per output
// boundary) binary-searches them.  Because the cumulative array is
// non-decreasing, the binary search equals the kernel's count
// #{m < L_real-1 : cum[m] <= t_j}.  Targets are float32 j·(n/β) as in the
// reference.  Boundaries and payload are gathered through the sort's index
// word, so they keep their dtype (f32 or i32) and their exact bits.
// Bound: device-memory bytes — the sort dominates (bitonic.cuh); the scan
// reads 8 bytes and writes 4 a key, the cuts read O(β log L).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;

// mass of the element with original flat index idx: sizes[src, b] for a
// bucket's left boundary, 0 for each source's last boundary and padding
__device__ __forceinline__ float mass_of(const float* sz, uint32_t idx,
                                         uint32_t lreal, uint32_t T) {
  if (idx >= lreal) return 0.0f;
  uint32_t src = idx / (T + 1), b = idx - src * (T + 1);
  return b < T ? sz[(size_t)src * T + b] : 0.0f;
}

__global__ void scan_kernel(const uint64_t* order, const float* sizes,
                            uint32_t k, uint32_t T, uint32_t L, float* cum) {
  __shared__ float warp_tot[kScanThreads / 32];
  __shared__ float chunk_tot;
  const uint64_t* o = order + (size_t)blockIdx.x * L;
  const float* sz = sizes + (size_t)blockIdx.x * k * T;
  float* c = cum + (size_t)blockIdx.x * L;
  uint32_t lreal = k * (T + 1);
  uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.0f;
  for (uint32_t base = 0; base < L; base += blockDim.x) {
    uint32_t m = base + threadIdx.x;
    float v = m < L ? mass_of(sz, (uint32_t)o[m], lreal, T) : 0.0f;
    for (int d = 1; d < 32; d <<= 1) {
      float up = __shfl_up_sync(0xFFFFFFFFu, v, d);
      if (lane >= (uint32_t)d) v += up;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < blockDim.x / 32 ? warp_tot[lane] : 0.0f;
      for (int d = 1; d < 32; d <<= 1) {
        float up = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= (uint32_t)d) w += up;
      }
      warp_tot[lane] = w;  // inclusive over warps
      if (lane == 31) chunk_tot = w;
    }
    __syncthreads();
    if (warp > 0) v += warp_tot[warp - 1];
    if (m < L) c[m] = carry + v;
    carry += chunk_tot;
    __syncthreads();  // warp_tot / chunk_tot reused by the next chunk
  }
}

// cut_j = #{m < lreal-1 : cum[m] <= j·(n/β)}, 1 <= j < β
__device__ __forceinline__ uint32_t cut_of(const float* c, uint32_t lreal,
                                           float n, uint32_t beta, uint32_t j) {
  float t = __fmul_rn((float)j, __fdiv_rn(n, (float)beta));
  uint32_t lo = 0, hi = lreal - 1;
  while (lo < hi) {
    uint32_t mid = (lo + hi) >> 1;
    if (c[mid] <= t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// cumulative size at output boundary j: 0, cum[cut_j - 1] (0 when the cut
// is 0) or n
__device__ __forceinline__ float full_at(const float* c, uint32_t lreal,
                                         float n, uint32_t beta, uint32_t j) {
  if (j == 0) return 0.0f;
  if (j == beta) return n;
  uint32_t cut = cut_of(c, lreal, n, beta, j);
  return cut > 0 ? c[cut - 1] : 0.0f;
}

__global__ void cut_kernel(const uint64_t* order, const float* cum,
                           const uint32_t* bounds, uint32_t Q, uint32_t lreal,
                           uint32_t L, uint32_t beta, uint32_t* bo, float* so) {
  uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (uint64_t)Q * (beta + 1)) return;
  uint32_t q = (uint32_t)(t / (beta + 1)), j = (uint32_t)(t % (beta + 1));
  const float* c = cum + (size_t)q * L;
  const uint64_t* o = order + (size_t)q * L;
  float n = c[L - 1];
  uint32_t at = j == 0 ? 0u : (j == beta ? lreal - 1 : cut_of(c, lreal, n, beta, j));
  bo[t] = bounds[(size_t)q * lreal + (uint32_t)o[at]];
  if (j < beta)
    so[(size_t)q * beta + j] =
        __fsub_rn(full_at(c, lreal, n, beta, j + 1), full_at(c, lreal, n, beta, j));
}

}  // namespace

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// order (Q, L) from hk_argsort over bounds (Q, k(T+1)); sizes (Q, k, T)
// float32; cum (Q, L) float32 scratch; outputs bo (Q, β+1) with the
// bounds' 4-byte dtype and so (Q, β) float32.
int hk_merge_cut(const void* order, const void* bounds, const float* sizes,
                 float* cum, int Q, int k, int T, int L, int beta, void* bo,
                 float* so, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* ord = static_cast<const uint64_t*>(order);
  scan_kernel<<<Q, kScanThreads, 0, st>>>(ord, sizes, k, T, L, cum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  uint64_t total = (uint64_t)Q * (beta + 1);
  cut_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      ord, cum, static_cast<const uint32_t*>(bounds), Q, (uint32_t)k * (T + 1),
      L, beta, static_cast<uint32_t*>(bo), so);
  return (int)cudaGetLastError();
}

}  // extern "C"

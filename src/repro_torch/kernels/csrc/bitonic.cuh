// Shared device code of the port's sort kernels: order-preserving key
// codecs and a bitonic sorting network over rows that may be far larger
// than one SM's shared memory.
//
// Replaces the networks `_bitonic` / `_bitonic_kv` of
// src/repro/kernels/tile_sort.py, which sort one VMEM-resident tile.  On
// Hopper a block has 227 KB of shared memory, so a row of 2^20 keys (or a
// merge problem of 65,536 64-bit keys) is sorted in three kinds of launch:
//
//   tile_sort   every stage with compare distance < TILE, from the first,
//               in shared memory, one block per TILE-key tile;
//   global_pass one stage with distance j >= TILE, straight over device
//               memory, one thread per compare-exchange pair;
//   tile_merge  the stages j < TILE of one merge step k > TILE, in
//               shared memory.
//
// Each global pass reads and writes the whole array once, so the sort is
// bound by device-memory bytes: log2(N/TILE)·(log2(N/TILE)+1)/2 global
// passes plus log2(N/TILE)+1 shared-memory passes over the array.
//
// Keys are unsigned.  A value's key compares like the value does under
// jnp.sort / torch.sort: NaN after +inf (all NaNs one key), -0 == +0.
// Rows are padded virtually to a power of two with the largest key.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hk {

// dtype codes shared with the Python wrappers (kernels/_lib.py)
constexpr int kF32 = 0;
constexpr int kI32 = 1;

// shared-memory tile: 32 KB of keys, under the 48 KB static limit
constexpr int kTileBytes = 32768;

__device__ __forceinline__ uint32_t enc_key(int dtype, uint32_t u) {
  if (dtype == kI32) return u ^ 0x80000000u;
  float x = __uint_as_float(u);
  if (x != x) return 0xFFFFFFFFu;       // every NaN: one key, after +inf
  if (x == 0.0f) return 0x80000000u;    // -0 and +0: one key
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t dec_key(int dtype, uint32_t k) {
  if (dtype == kI32) return k ^ 0x80000000u;
  return (k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k;
}

// index of the lower element of compare-exchange pair p at distance j
__device__ __forceinline__ uint32_t pair_lo(uint32_t p, uint32_t j) {
  return ((p & ~(j - 1u)) << 1) | (p & (j - 1u));
}

// one network stage over a shared-memory tile whose first key sits at
// row position g0; the direction of a pair follows bit kk of its position
template <typename K>
__device__ __forceinline__ void smem_stage(K* s, uint32_t tl, uint32_t j,
                                           uint32_t g0, uint32_t kk) {
  for (uint32_t p = threadIdx.x; p < tl / 2; p += blockDim.x) {
    uint32_t i = pair_lo(p, j);
    bool asc = ((g0 + i) & kk) == 0;
    K a = s[i], b = s[i + j];
    if ((a > b) == asc) {
      s[i] = b;
      s[i + j] = a;
    }
  }
}

// all stages k = 2..tl of the network on each tile, keys from `load`
template <typename K, class Load>
__global__ void tile_sort_kernel(K* keys, uint32_t n, uint32_t tl, Load load) {
  __shared__ K s[kTileBytes / sizeof(K)];
  uint32_t tiles = n / tl;
  uint32_t row = blockIdx.x / tiles;
  uint32_t g0 = (blockIdx.x % tiles) * tl;
  for (uint32_t t = threadIdx.x; t < tl; t += blockDim.x) s[t] = load(row, g0 + t);
  for (uint32_t kk = 2; kk <= tl; kk <<= 1) {
    for (uint32_t j = kk >> 1; j > 0; j >>= 1) {
      __syncthreads();
      smem_stage(s, tl, j, g0, kk);
    }
  }
  __syncthreads();
  K* out = keys + (size_t)row * n + g0;
  for (uint32_t t = threadIdx.x; t < tl; t += blockDim.x) out[t] = s[t];
}

// stages j = tl/2..1 of merge step kk (> tl) on each tile
template <typename K>
__global__ void tile_merge_kernel(K* keys, uint32_t n, uint32_t tl, uint32_t kk) {
  __shared__ K s[kTileBytes / sizeof(K)];
  uint32_t tiles = n / tl;
  uint32_t row = blockIdx.x / tiles;
  uint32_t g0 = (blockIdx.x % tiles) * tl;
  K* r = keys + (size_t)row * n + g0;
  for (uint32_t t = threadIdx.x; t < tl; t += blockDim.x) s[t] = r[t];
  for (uint32_t j = tl >> 1; j > 0; j >>= 1) {
    __syncthreads();
    smem_stage(s, tl, j, g0, kk);
  }
  __syncthreads();
  for (uint32_t t = threadIdx.x; t < tl; t += blockDim.x) r[t] = s[t];
}

// one stage (kk, j >= tl) over device memory, one thread per pair
template <typename K>
__global__ void global_pass_kernel(K* keys, uint32_t n, uint64_t pairs,
                                   uint32_t kk, uint32_t j) {
  uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  uint64_t row = t / (n / 2);
  uint32_t i = pair_lo((uint32_t)(t % (n / 2)), j);
  bool asc = (i & kk) == 0;
  K* r = keys + row * n;
  K a = r[i], b = r[i + j];
  if ((a > b) == asc) {
    r[i] = b;
    r[i + j] = a;
  }
}

// Sort `rows` rows of n keys (n a power of two) into `keys`, the first
// pass reading through `load(row, position)`.  Returns the first launch
// error, checked after every launch.
template <typename K, class Load>
cudaError_t bitonic_rows(K* keys, uint32_t rows, uint32_t n, Load load,
                         cudaStream_t st) {
  const uint32_t tile = kTileBytes / sizeof(K);
  uint32_t tl = n < tile ? n : tile;
  uint32_t blocks = rows * (n / tl);
  uint32_t threads = tl / 2 < 32 ? 32 : (tl / 2 > 512 ? 512 : tl / 2);
  tile_sort_kernel<K, Load><<<blocks, threads, 0, st>>>(keys, n, tl, load);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  uint64_t pairs = (uint64_t)rows * (n / 2);
  uint32_t pass_blocks = (uint32_t)((pairs + 255) / 256);
  for (uint64_t kk = 2ull * tl; kk <= n; kk <<= 1) {
    for (uint64_t j = kk >> 1; j >= tl; j >>= 1) {
      global_pass_kernel<K><<<pass_blocks, 256, 0, st>>>(
          keys, n, pairs, (uint32_t)kk, (uint32_t)j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    tile_merge_kernel<K><<<blocks, threads, 0, st>>>(keys, n, tl, (uint32_t)kk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace hk

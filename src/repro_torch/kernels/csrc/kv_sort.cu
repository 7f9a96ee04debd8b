// Stable key/value sort, shared by the standalone kv sort and the merge.
//
// Replaces `tile_sort_kv_kernel` (src/repro/kernels/tile_sort.py:125,
// network `_bitonic_kv` at :78, wrapper `sort_kv_pallas`), which sorts the
// lexicographic pair (key, original index) so that the result is exactly
// argsort(key, stable=True).
//
// Design: the pair is one 64-bit key, (order-preserving 32-bit key << 32)
// | original index, so the bitonic network of bitonic.cuh sorts a total
// order and needs no payload lane.  The payload, and the key's own bits
// (which keep -0 and NaN payloads), are gathered afterwards through the
// index in the low word.  Positions past a row's real length get the
// largest high word, so they sort after every real element.
// Bound: device-memory bytes, 8 bytes a key per pass (bitonic.cuh); the
// shared-memory tile holds 4,096 keys.
#include "bitonic.cuh"

namespace {

struct LoadPair {
  const uint32_t* src;
  uint32_t lreal;  // real elements per row; the rest is padding
  int dtype;
  __device__ uint64_t operator()(uint32_t row, uint32_t g) const {
    uint32_t hi = g < lreal ? hk::enc_key(dtype, src[(size_t)row * lreal + g])
                            : 0xFFFFFFFFu;
    return ((uint64_t)hi << 32) | g;
  }
};

__global__ void kv_gather_kernel(const uint64_t* order, const uint32_t* keys,
                                 const uint32_t* vals, uint32_t rows,
                                 uint32_t L, uint32_t Lp, uint32_t* ko,
                                 uint32_t* vo) {
  uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (uint64_t)rows * L) return;
  uint64_t row = t / L, base = row * L;
  uint32_t src = (uint32_t)order[row * Lp + (t - base)];
  ko[t] = keys[base + src];
  vo[t] = vals[base + src];
}

}  // namespace

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sorted (key, index) pairs (rows, L) of the 4-byte keys src (rows, lreal),
// L a power of two >= lreal.
int hk_argsort(const void* src, void* order, int rows, int lreal, int L,
               int dtype, void* stream) {
  LoadPair load{static_cast<const uint32_t*>(src), (uint32_t)lreal, dtype};
  return (int)hk::bitonic_rows<uint64_t>(static_cast<uint64_t*>(order),
                                         (uint32_t)rows, (uint32_t)L, load,
                                         static_cast<cudaStream_t>(stream));
}

// keys and values (rows, L) in the order (rows, Lp) that hk_argsort
// produced for them; the first L pairs of each row are the real ones.
int hk_kv_gather(const void* order, const void* keys, const void* vals,
                 int rows, int L, int Lp, void* ko, void* vo, void* stream) {
  uint64_t total = (uint64_t)rows * L;
  kv_gather_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(order), static_cast<const uint32_t*>(keys),
      static_cast<const uint32_t*>(vals), rows, L, Lp,
      static_cast<uint32_t*>(ko), static_cast<uint32_t*>(vo));
  return (int)cudaGetLastError();
}

}  // extern "C"

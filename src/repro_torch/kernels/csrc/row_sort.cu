// Row sort: the Summarizer's sort, with the cut gather of build_exact.
//
// Replaces `tile_sort_kernel` (src/repro/kernels/tile_sort.py:119, wrapper
// `sort_tiles_pallas`), which the JAX package's Summarizer path runs as
// `jnp.sort` (src/repro/core/histogram.py:217 and :140).
//
// Bound: device-memory bytes.  A row of n keys needs one read and one write
// of 4n bytes at least; this network moves the array once per pass (see
// bitonic.cuh), so it is some (log2(n/8192)+1)(log2(n/8192)+2)/2 times that.
// Design: order-preserving 32-bit keys (f32 and i32 share one network),
// global passes for the wide stages, shared-memory tiles for the rest; the
// gather of the T+1 boundaries reads only the cut positions and decodes.
#include "bitonic.cuh"

namespace {

struct LoadRow {
  const uint32_t* src;
  uint32_t width;  // real length of each source row
  int dtype;
  __device__ uint32_t operator()(uint32_t row, uint32_t g) const {
    return g < width ? hk::enc_key(dtype, src[(size_t)row * width + g]) : 0xFFFFFFFFu;
  }
};

__global__ void decode_kernel(const uint32_t* keys, uint32_t rows, uint32_t n,
                              uint32_t width, int dtype, uint32_t* out) {
  uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (uint64_t)rows * width) return;
  uint64_t row = t / width;
  uint32_t g = (uint32_t)(t % width);
  out[t] = hk::dec_key(dtype, keys[row * n + g]);
}

// boundary i of row r: sorted[min(floor(i·n_r/T), n_r - 1)], with the
// reference's exact integer form i·q + (i·rem)/T of the cut
__global__ void gather_cuts_kernel(const uint32_t* keys, const int32_t* ns,
                                   uint32_t rows, uint32_t n, uint32_t T,
                                   int dtype, uint32_t* out) {
  uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (uint64_t)rows * (T + 1)) return;
  uint64_t row = t / (T + 1);
  int64_t i = (int64_t)(t % (T + 1));
  int64_t nr = ns[row];
  int64_t cut = i * (nr / T) + (i * (nr % T)) / T;
  if (cut > nr - 1) cut = nr - 1;
  out[t] = hk::dec_key(dtype, keys[row * n + cut]);
}

}  // namespace

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sort each of `rows` rows of `width` 4-byte values into `keys`
// (rows, n) uint32, n = next power of two >= width.  With `out` given,
// also decode the first `width` keys of each row back to values there.
int hk_row_sort(const void* src, void* keys, int rows, int width, int n,
                int dtype, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LoadRow load{static_cast<const uint32_t*>(src), (uint32_t)width, dtype};
  cudaError_t err = hk::bitonic_rows<uint32_t>(
      static_cast<uint32_t*>(keys), (uint32_t)rows, (uint32_t)n, load, st);
  if (err != cudaSuccess || out == nullptr) return (int)err;
  uint64_t total = (uint64_t)rows * width;
  decode_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const uint32_t*>(keys), rows, n, width, dtype,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// Boundaries (rows, T+1) of the sorted keys at the masked cuts of ns.
int hk_row_gather(const void* keys, const void* ns, int rows, int n, int T,
                  int dtype, void* out, void* stream) {
  uint64_t total = (uint64_t)rows * (T + 1);
  gather_cuts_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(ns),
      rows, n, T, dtype, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"

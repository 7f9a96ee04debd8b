// Row sort: the Summarizer's sort, with the cut gather of build_exact.
//
// Replaces `tile_sort_kernel` (src/repro/kernels/tile_sort.py:119, wrapper
// `sort_tiles_pallas`), which the JAX package's Summarizer path runs as
// `jnp.sort` (src/repro/core/histogram.py:217 and :140).
//
// Bound: device-memory bytes.  A row of n keys needs one read and one write
// of 4n bytes at least.  The stable LSD radix sort of radix_sort.cuh moves
// 8 bytes a key when the row fits one block's shared memory (resident) and
// 36 bytes a key otherwise (onesweep: one histogram read, four passes that
// each read and write the row), against some 288 for the bitonic network
// it replaced.  Design: order-preserving 32-bit keys (f32 and i32 share
// one sort), encoded on the first load and decoded on the last write; the
// gather of the T+1 boundaries reads only the cut positions and decodes.
#include "radix_sort.cuh"

namespace {

// boundary i of row r: sorted[min(floor(i·n_r/T), n_r - 1)], with the
// reference's exact integer form i·q + (i·rem)/T of the cut
__global__ void gather_cuts_kernel(const uint32_t* keys, const int32_t* ns,
                                   uint32_t rows, uint32_t width, uint32_t T,
                                   int dtype, uint32_t* out) {
  uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (uint64_t)rows * (T + 1)) return;
  uint64_t row = t / (T + 1);
  int64_t i = (int64_t)(t % (T + 1));
  int64_t nr = ns[row];
  int64_t cut = i * (nr / T) + (i * (nr % T)) / T;
  if (cut > nr - 1) cut = nr - 1;
  out[t] = hk::dec_key(dtype, keys[row * width + cut]);
}

}  // namespace

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sort each of `rows` rows of `width` 4-byte values of src into `out`
// (rows, width): encoded keys (mode 0) or values (mode 1).  cap > 0 runs
// the resident kernel of that capacity, cap == 0 onesweep, which uses
// `tmp` (rows, width) and the zeroed `scratch` words
// (tile_sort.onesweep_scratch_words).
int hk_row_sort(const void* src, void* out, int mode, int rows, int width,
                int dtype, int cap, void* tmp, void* scratch, void* stream) {
  if (mode != hk::kKeys && mode != hk::kValues) return (int)cudaErrorInvalidValue;
  hk::SortArgs a{};
  a.src = static_cast<const uint32_t*>(src);
  a.out0 = out;
  a.kbuf[0] = static_cast<uint32_t*>(tmp);
  a.kbuf[1] = static_cast<uint32_t*>(out);  // pass 1 writes where pass 3 will
  a.rows = (uint32_t)rows;
  a.width = (uint32_t)width;
  a.stride = (uint32_t)width;
  a.dtype = dtype;
  a.mode = mode;
  return (int)hk::radix_rows<false>(a, cap, static_cast<uint32_t*>(scratch),
                                    static_cast<cudaStream_t>(stream));
}

// Boundaries (rows, T+1) of the sorted keys (rows, width) at the masked
// cuts of ns.
int hk_row_gather(const void* keys, const void* ns, int rows, int width, int T,
                  int dtype, void* out, void* stream) {
  uint64_t total = (uint64_t)rows * (T + 1);
  gather_cuts_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(ns),
      rows, width, T, dtype, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"

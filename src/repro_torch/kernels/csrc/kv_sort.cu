// Stable key/value sort, shared by the standalone kv sort and the merge.
//
// Replaces `tile_sort_kv_kernel` (src/repro/kernels/tile_sort.py:125,
// network `_bitonic_kv` at :78, wrapper `sort_kv_pallas`), which sorts the
// lexicographic pair (key, original index) so that the result is exactly
// argsort(key, stable=True).
//
// Design: the stable LSD radix sort of radix_sort.cuh on the 32-bit
// order-preserving key; stability alone gives the (key, index) order, with
// no 64-bit compare.  The merge's pairs (key << 32) | index carry the
// original index through the passes and get the padding past a row's real
// length (largest key, index = position) written directly; the standalone
// sort carries the keys' own bits (which keep -0 and NaN payloads, encoded
// again for each digit) and the payload itself, so nothing is gathered
// at the end.
// Bound: device-memory bytes.  Resident rows (up to 16,384 pairs) move
// 8 bytes in and 8 out a pair; onesweep moves 4 + 4·16 = 68 a pair (one
// histogram read, four passes of key and payload), against some 240 for
// the bitonic network it replaced.
#include "radix_sort.cuh"

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Stable sort of the 4-byte keys (rows, width).  mode 2: out0 = (rows,
// stride) int64 pairs (key << 32) | original index, stride >= width,
// positions past width padded.  mode 3: out0 = the sorted keys' bits, out1
// = vals (rows, width) in the same order.  cap > 0 runs the resident kernel
// of that capacity, cap == 0 onesweep, which uses the ping-pong buffers
// k0, k1, i0, i1 (rows, width) and the zeroed `scratch` words
// (tile_sort.onesweep_scratch_words).
int hk_kv_sort(const void* keys, const void* vals, void* out0, void* out1,
               int mode, int rows, int width, int stride, int dtype, int cap,
               void* k0, void* k1, void* i0, void* i1, void* scratch,
               void* stream) {
  if (mode != hk::kPairs && mode != hk::kGather) return (int)cudaErrorInvalidValue;
  if (mode == hk::kGather ? stride != width : stride < width)
    return (int)cudaErrorInvalidValue;
  hk::SortArgs a{};
  a.src = static_cast<const uint32_t*>(keys);
  a.vals = static_cast<const uint32_t*>(vals);
  a.out0 = out0;
  a.out1 = out1;
  a.kbuf[0] = static_cast<uint32_t*>(k0);
  a.kbuf[1] = static_cast<uint32_t*>(k1);
  a.ibuf[0] = static_cast<uint32_t*>(i0);
  a.ibuf[1] = static_cast<uint32_t*>(i1);
  a.rows = (uint32_t)rows;
  a.width = (uint32_t)width;
  a.stride = (uint32_t)stride;
  a.dtype = dtype;
  a.mode = mode;
  return (int)hk::radix_rows<true>(a, cap, static_cast<uint32_t*>(scratch),
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"

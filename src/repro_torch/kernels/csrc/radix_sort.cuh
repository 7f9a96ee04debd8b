// Shared device code of the port's sort kernels: the order-preserving key
// codec and a stable LSD radix sort of rows, four passes of 8-bit digits.
//
// Replaces the networks `_bitonic` / `_bitonic_kv` of
// src/repro/kernels/tile_sort.py, which sort one VMEM-resident tile.  Each
// 32-bit key is sorted by its four bytes, least significant first; every
// pass is stable, so a sort that carries a payload (the original index, or
// the value itself) yields exactly the (key, index) order of a stable
// sort, with no 64-bit compare.  Two regimes:
//
//   resident  a row that fits one block's dynamic shared memory (up to
//             227 KB, opted into above 48 KB) is loaded once, ranked four
//             times in shared memory and registers, and written once: one
//             block per row, one launch.
//   onesweep  a longer row: one histogram launch reads every key once and
//             counts all four digits per row; a per-row scan turns the
//             counts into digit offsets; then one scatter launch per digit.
//             A scatter block takes its tile number from a global counter
//             (every earlier tile is then already running, so waiting on
//             it cannot deadlock), ranks the tile in shared memory, finds
//             its offset per digit by decoupled look-back over the row's
//             earlier tiles, and writes.
//
// Bound: device-memory bytes.  Onesweep moves 4 + 4·8 = 36 bytes a key for
// the row sort and 4 + 4·16 = 68 a key/value pair (the bitonic network it
// replaces moved some 288 and 240); resident moves 8 and 16.
//
// In-block ranking is stable and skew-proof: each warp owns a contiguous
// run of the tile and keeps private digit counters; a digit's lanes find
// each other through a shared bitmask word of the digit (atomicOr) and only
// the lowest of them updates the counter, so a tile of one repeated digit
// costs no more than a uniform one.  (__match_any_sync loops once per
// distinct value in the warp, some 30 times on uniform digits, and eight
// ballots a chunk cost more than the bitmask word: PERF.md.)
// Keys a block holds are item c of lane l in warp w at tile position
// w·32·ITEMS + c·32 + l: coalesced loads, and the (warp, chunk, lane)
// order is the tile order, which is what makes the ranking stable.
//
// Keys are unsigned.  A value's key compares like the value does under
// jnp.sort / torch.sort: NaN after +inf (all NaNs one key), -0 == +0.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hk {

// dtype codes shared with the Python wrappers (kernels/_lib.py)
constexpr int kF32 = 0;
constexpr int kI32 = 1;

// what the last pass writes (kernels/tile_sort.py: _KEYS .. _GATHER)
constexpr int kKeys = 0;    // encoded keys, (rows, width) uint32
constexpr int kValues = 1;  // decoded values, (rows, width) 4-byte
constexpr int kPairs = 2;   // (key << 32) | index, (rows, stride) uint64, padded
constexpr int kGather = 3;  // the source keys and payload in sorted order

// onesweep geometry (kernels/tile_sort.py mirrors these)
constexpr int kLongWarps = 16;
constexpr int kLongItems = 16;
constexpr uint32_t kLongTile = kLongWarps * 32 * kLongItems;  // 8,192 keys
// keys per histogram block: the most, halved down to the least while the
// launch would have fewer than kHistBlocks blocks (31 rows of 2^16 keys
// must not leave the card idle)
constexpr uint32_t kHistChunk = 1u << 16;
constexpr uint32_t kHistMinChunk = 1u << 12;
constexpr uint64_t kHistBlocks = 2048;

// look-back status word: flag in the top two bits, a count below
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;
constexpr uint32_t kCountMask = kAggregate - 1u;

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

// Digit `shift` of a key held encoded (codec < 0) or as the raw bits of
// dtype `codec` (the kv sort's kGather mode keeps the keys' own bits).
__device__ __forceinline__ uint32_t digit_of(uint32_t k, int shift, int codec) {
  return ((codec < 0 ? k : enc_key(codec, k)) >> shift) & 0xFFu;
}

struct SortArgs {
  const uint32_t* src;   // (rows, width) raw 4-byte keys
  const uint32_t* vals;  // (rows, width) payload (kGather)
  void* out0;            // kKeys/kValues/kPairs: the result; kGather: keys
  void* out1;            // kGather: payload
  // kGather carries the raw key bits and the payload itself through the
  // passes (no gather at the end); the other modes carry encoded keys and,
  // for kPairs, the original index
  uint32_t* kbuf[2];     // onesweep ping-pong keys (rows, width)
  uint32_t* ibuf[2];     // onesweep ping-pong index or payload (kv only)
  uint32_t rows, width;  // width: real keys per row
  uint32_t stride;       // row stride of the result (kPairs: L >= width)
  int dtype, mode;
};

// the result's element at sorted position dst of a row
__device__ __forceinline__ void write_out(const SortArgs& a, uint32_t row,
                                          uint32_t dst, uint32_t key,
                                          uint32_t idx) {
  size_t o = (size_t)row * a.stride + dst;
  switch (a.mode) {
    case kKeys:
      static_cast<uint32_t*>(a.out0)[o] = key;
      break;
    case kValues:
      static_cast<uint32_t*>(a.out0)[o] = dec_key(a.dtype, key);
      break;
    case kPairs:
      static_cast<uint64_t*>(a.out0)[o] = ((uint64_t)key << 32) | idx;
      break;
    default:  // kGather: key bits and payload
      static_cast<uint32_t*>(a.out0)[o] = key;
      static_cast<uint32_t*>(a.out1)[o] = idx;
  }
}

// kPairs: positions width..stride-1 of a row sort last, index = position
__device__ __forceinline__ void write_pads(const SortArgs& a, uint32_t row) {
  if (a.mode != kPairs) return;
  uint64_t* o = static_cast<uint64_t*>(a.out0) + (size_t)row * a.stride;
  for (uint32_t g = a.width + threadIdx.x; g < a.stride; g += blockDim.x)
    o[g] = (0xFFFFFFFFull << 32) | g;
}

// ---- in-block stable ranking (both regimes) ------------------------------
//
// Shared memory of a ranking block with W warps: cnt[W][256] (per-warp
// digit counters), mbins[W][256] (per-warp digit bitmasks), gsum[W/8][256],
// total[256], start[256], wsum[8].  A block ranks its keys once a pass
// (rank_digits), scans the digit totals (scan_digits) and places every key
// at its sorted position in shared memory (place_local).

// Ranks of the block's valid keys (tile positions below nvalid) among
// their digit in their warp, into rk (16 bits a key, two keys a register).
// A chunk's lanes of one digit find each other by setting their bits in
// the warp's bitmask word of that digit, mbins[w][d] (atomicOr, then one
// read); the lowest of them reads and advances the warp's counter of d,
// clears the word, and shares the old count by a shuffle.  Then every
// thread (digit d = t mod 256, group q = t / 256 of eight warps) turns its
// group's counters of d into exclusive counts within the group, and
// threads 0..255 turn the group sums gsum[q][d] into exclusive counts over
// groups and total[d], the block's count.  Ends with threads 0..255 having
// written total[threadIdx.x] (visible to the writer only until the next
// barrier).
template <int W, int ITEMS>
__device__ __forceinline__ void rank_digits(const uint32_t (&k)[ITEMS],
                                            int shift, int codec,
                                            uint32_t nvalid,
                                            uint32_t* cnt, uint32_t* gsum,
                                            uint32_t* total,
                                            uint32_t (&rk)[(ITEMS + 1) / 2],
                                            uint32_t* mbins) {
  static_assert(W % 8 == 0, "a block holds whole groups of eight warps");
  const uint32_t w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* wc = cnt + w * 256;
  uint32_t* mb = mbins + w * 256;
  for (uint32_t i = lane; i < 256; i += 32) wc[i] = 0;
  for (uint32_t i = lane; i < 256; i += 32) mb[i] = 0;
  __syncwarp();
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < (ITEMS + 1) / 2; ++c) rk[c] = 0;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t first = w * 32 * ITEMS + c * 32;
    if (first >= nvalid) break;  // warp-uniform
    const bool valid = first + lane < nvalid;
    const uint32_t d = digit_of(k[c], shift, codec);
    // the digit's lanes: each sets its bit in the warp's word of digit d
    if (valid) atomicOr(&mb[d], 1u << lane);
    __syncwarp();
    const uint32_t peers = valid ? mb[d] : 0u;
    __syncwarp();
    const uint32_t leader = valid ? (uint32_t)(__ffs(peers) - 1) : lane;
    uint32_t base = 0;
    if (valid && lane == leader) {  // one lane a digit: plain shared access
      base = wc[d];
      wc[d] = base + __popc(peers);
      mb[d] = 0;
    }
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    __syncwarp();
    rk[c / 2] |= (base + __popc(peers & below)) << (16 * (c & 1));
  }
  __syncthreads();
  {
    const uint32_t d = threadIdx.x & 255u, q = threadIdx.x >> 8;
    uint32_t run = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      uint32_t* e = cnt + (q * 8 + v) * 256 + d;
      const uint32_t x = *e;
      *e = run;
      run += x;
    }
    gsum[q * 256 + d] = run;
  }
  __syncthreads();
  if (threadIdx.x < 256) {
    uint32_t run = 0;
#pragma unroll
    for (int q = 0; q < W / 8; ++q) {
      const uint32_t x = gsum[q * 256 + threadIdx.x];
      gsum[q * 256 + threadIdx.x] = run;
      run += x;
    }
    total[threadIdx.x] = run;
  }
}

// start[d] = exclusive sum of total[0..d), over threads 0..255; called by
// every thread of the block (two barriers).
__device__ __forceinline__ void scan_digits(const uint32_t* total,
                                            uint32_t* start, uint32_t* wsum) {
  const uint32_t t = threadIdx.x, lane = t & 31;
  uint32_t x = 0, v = 0;
  if (t < 256) {
    x = total[t];
    v = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      uint32_t n = __shfl_up_sync(0xFFFFFFFFu, v, o);
      if (lane >= (uint32_t)o) v += n;
    }
    if (lane == 31) wsum[t >> 5] = v;
  }
  __syncthreads();
  if (t < 256) {
    uint32_t add = 0;
    for (uint32_t i = 0; i < (t >> 5); ++i) add += wsum[i];
    start[t] = add + v - x;
  }
  __syncthreads();
}

// Each valid key to its block-local sorted position start[d] + (digit d
// in earlier groups) + (in earlier warps of its group) + its rank in its
// warp, in skey (and its index in sidx).  The caller must have finished
// reading skey/sidx before scan_digits' barriers.
template <int W, int ITEMS, bool KV>
__device__ __forceinline__ void place_local(const uint32_t (&k)[ITEMS],
                                            const uint32_t (&ix)[ITEMS],
                                            const uint32_t (&rk)[(ITEMS + 1) / 2],
                                            int shift, int codec,
                                            uint32_t nvalid, uint32_t* cnt,
                                            const uint32_t* gsum,
                                            const uint32_t* start,
                                            uint32_t* skey, uint32_t* sidx) {
  const uint32_t w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* wc = cnt + w * 256;
  const uint32_t* gp = gsum + (w >> 3) * 256;
  for (uint32_t i = lane; i < 256; i += 32) wc[i] += start[i] + gp[i];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t pos = w * 32 * ITEMS + c * 32 + lane;
    if (pos < nvalid) {
      const uint32_t r = wc[digit_of(k[c], shift, codec)] +
                         ((rk[c / 2] >> (16 * (c & 1))) & 0xFFFFu);
      skey[r] = k[c];
      if (KV) sidx[r] = ix[c];
    }
  }
}

// ---- resident regime -----------------------------------------------------

template <int W, int ITEMS, bool KV>
constexpr size_t resident_smem() {
  return sizeof(uint32_t) * ((KV ? 2 : 1) * (size_t)W * 32 * ITEMS + W * 256 +
                             256 + 256 + 8 + W / 8 * 256 + W * 256);
}

// The four passes of a resident block over the n keys it holds in k (and
// their payload in ix), item c of lane l in warp w at tile position
// w·32·ITEMS + c·32 + l.  Leaves the keys sorted in sm[0, n) and, KV, the
// payload in sm[C, C + n), C = W·32·ITEMS, and ends with a barrier; the
// rest of the block's resident_smem is free again.  The sort kernel and
// the merge's resident kernel (merge_cut.cu) both run it.
template <int W, int ITEMS, bool KV>
__device__ __forceinline__ void resident_passes(uint32_t (&k)[ITEMS],
                                                uint32_t (&ix)[ITEMS],
                                                uint32_t n, int codec,
                                                uint32_t* sm) {
  constexpr uint32_t C = W * 32 * ITEMS;
  uint32_t* skey = sm;
  uint32_t* sidx = sm + C;  // KV only
  uint32_t* cnt = sm + (KV ? 2 : 1) * C;
  uint32_t* total = cnt + W * 256;
  uint32_t* start = total + 256;
  uint32_t* wsum = start + 256;
  uint32_t* gsum = wsum + 8;
  uint32_t* mbins = gsum + W / 8 * 256;
  const uint32_t first = (threadIdx.x >> 5) * 32 * ITEMS + (threadIdx.x & 31);
  for (int p = 0; p < 4; ++p) {
    if (p > 0) {
#pragma unroll
      for (int c = 0; c < ITEMS; ++c) {
        const uint32_t pos = first + c * 32;
        if (pos < n) {
          k[c] = skey[pos];
          if (KV) ix[c] = sidx[pos];
        }
      }
    }
    uint32_t rk[(ITEMS + 1) / 2];
    rank_digits<W, ITEMS>(k, 8 * p, codec, n, cnt, gsum, total, rk, mbins);
    scan_digits(total, start, wsum);
    place_local<W, ITEMS, KV>(k, ix, rk, 8 * p, codec, n, cnt, gsum, start,
                              skey, sidx);
    __syncthreads();
  }
}

// One block sorts one row of a.width <= W·32·ITEMS keys in shared memory.
template <int W, int ITEMS, bool KV>
__global__ void __launch_bounds__(W * 32) resident_kernel(SortArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr uint32_t C = W * 32 * ITEMS;
  const uint32_t* skey = sm;
  const uint32_t* sidx = sm + C;  // KV only
  const uint32_t row = blockIdx.x, n = a.width;
  const uint32_t first = (threadIdx.x >> 5) * 32 * ITEMS + (threadIdx.x & 31);
  const int codec = a.mode == kGather ? a.dtype : -1;
  const uint32_t* src = a.src + (size_t)row * n;
  uint32_t k[ITEMS], ix[ITEMS];
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t pos = first + c * 32;
    k[c] = 0xFFFFFFFFu;
    ix[c] = pos;
    if (pos < n) {
      k[c] = codec < 0 ? enc_key(a.dtype, src[pos]) : src[pos];
      if (KV && codec >= 0) ix[c] = a.vals[(size_t)row * n + pos];
    }
  }
  resident_passes<W, ITEMS, KV>(k, ix, n, codec, sm);
  for (uint32_t j = threadIdx.x; j < n; j += W * 32)
    write_out(a, row, j, skey[j], KV ? sidx[j] : 0u);
  write_pads(a, row);
}

template <int W, int ITEMS, bool KV>
cudaError_t run_resident(const SortArgs& a, cudaStream_t st) {
  constexpr size_t smem = resident_smem<W, ITEMS, KV>();
  cudaError_t err = cudaFuncSetAttribute(
      resident_kernel<W, ITEMS, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  resident_kernel<W, ITEMS, KV><<<a.rows, W * 32, smem, st>>>(a);
  return cudaGetLastError();
}

// The resident capacities (keys a row may hold), each its own block shape;
// kernels/tile_sort.py lists the same ones.  The kv sort stops at 16,384
// pairs (8 bytes each in shared memory).
template <bool KV>
cudaError_t launch_resident(const SortArgs& a, int cap, cudaStream_t st) {
  if (a.width > (uint32_t)cap) return cudaErrorInvalidValue;
  switch (cap) {
    case 256: return run_resident<8, 1, KV>(a, st);
    case 512: return run_resident<8, 2, KV>(a, st);
    case 1024: return run_resident<8, 4, KV>(a, st);
    case 2048: return run_resident<8, 8, KV>(a, st);
    case 4096: return run_resident<8, 16, KV>(a, st);
    case 8192: return run_resident<16, 16, KV>(a, st);
    case 16384: return run_resident<32, 16, KV>(a, st);
    case 32768:
      if constexpr (!KV) return run_resident<32, 32, false>(a, st);
      break;
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

// ---- onesweep regime ------------------------------------------------------

// Every digit of every key of a row, counted into counts[row][pass][256].
// A warp counts into its own histograms; a thread keeps, per digit
// position, the digit it saw last and how often in a row, and adds a run
// to shared memory only when the digit changes.  Skewed positions (a
// float's sign and exponent byte, the sign bytes of small integers) then
// cost almost no atomics, and uniform ones one conflict-free atomic a key.
constexpr int kHistThreads = 256;
constexpr int kHistUnroll = 4;  // keys a thread loads at once

__global__ void __launch_bounds__(kHistThreads)
    histogram_kernel(const uint32_t* src, int dtype, uint32_t width,
                     uint32_t chunk, uint32_t chunks, uint32_t* counts) {
  constexpr int kWarps = kHistThreads / 32;
  __shared__ uint32_t h[kWarps * 4 * 256];
  for (uint32_t i = threadIdx.x; i < kWarps * 4 * 256; i += kHistThreads) h[i] = 0;
  __syncthreads();
  uint32_t* hw = h + (threadIdx.x >> 5) * 4 * 256;
  const uint32_t row = blockIdx.x / chunks;
  const uint32_t begin = (blockIdx.x % chunks) * chunk;
  const uint32_t end = min(width, begin + chunk);
  const uint32_t* r = src + (size_t)row * width;
  uint32_t prev[4] = {0, 0, 0, 0}, run[4] = {0, 0, 0, 0};
  for (uint32_t i0 = begin + threadIdx.x; i0 < end; i0 += kHistThreads * kHistUnroll) {
    uint32_t key[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const uint32_t i = i0 + u * kHistThreads;
      key[u] = i < end ? enc_key(dtype, r[i]) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (i0 + u * kHistThreads >= end) break;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t d = (key[u] >> (8 * p)) & 0xFFu;
        if (d != prev[p]) {
          if (run[p]) atomicAdd(&hw[p * 256 + prev[p]], run[p]);
          prev[p] = d;
          run[p] = 0;
        }
        ++run[p];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if (run[p]) atomicAdd(&hw[p * 256 + prev[p]], run[p]);
  __syncthreads();
  uint32_t* c = counts + (size_t)row * 1024;
  for (uint32_t i = threadIdx.x; i < 4 * 256; i += kHistThreads) {
    uint32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += h[w * 4 * 256 + i];
    if (sum) atomicAdd(&c[i], sum);
  }
}

// Per row and pass, counts → exclusive digit offsets, in place; and the
// kPairs padding.
__global__ void __launch_bounds__(256) digit_scan_kernel(uint32_t* counts,
                                                         SortArgs a) {
  __shared__ uint32_t total[256], start[256], wsum[8];
  for (int p = 0; p < 4; ++p) {
    uint32_t* c = counts + ((size_t)blockIdx.x * 4 + p) * 256;
    total[threadIdx.x] = c[threadIdx.x];
    __syncthreads();
    scan_digits(total, start, wsum);
    c[threadIdx.x] = start[threadIdx.x];
  }
  write_pads(a, blockIdx.x);
}

template <bool KV>
constexpr size_t onesweep_smem() {
  constexpr int W = kLongWarps;
  return sizeof(uint32_t) * ((KV ? 2 : 1) * (size_t)kLongTile + W * 256 +
                             256 * 3 + 8 + 1 + W / 8 * 256 + W * 256);
}

// One digit pass over tiles of kLongTile keys; see the file's head.
// RAW: kGather's raw key bits and payload (a template parameter, so that
// the other modes' kernel keeps the registers of two blocks an SM).
template <bool KV, bool RAW>
__global__ void __launch_bounds__(kLongWarps * 32)
    onesweep_kernel(SortArgs a, int pass, uint32_t tiles_per_row,
                    const uint32_t* offs, uint32_t* counter,
                    uint32_t* status) {
  constexpr int W = kLongWarps, ITEMS = kLongItems;
  constexpr uint32_t kTile = kLongTile;
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* skey = sm;
  uint32_t* sidx = sm + kTile;  // KV only
  uint32_t* cnt = sm + (KV ? 2 : 1) * kTile;
  uint32_t* total = cnt + W * 256;
  uint32_t* start = total + 256;
  uint32_t* gofs = start + 256;
  uint32_t* wsum = gofs + 256;
  uint32_t* slot = wsum + 8;
  uint32_t* gsum = slot + 1;
  uint32_t* mbins = gsum + W / 8 * 256;
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1u);
  __syncthreads();
  const uint32_t tile = *slot;
  const uint32_t row = tile / tiles_per_row, t = tile % tiles_per_row;
  const uint32_t base = t * kTile;
  const uint32_t n = min(kTile, a.width - base);
  const int shift = 8 * pass;
  const size_t rb = (size_t)row * a.width + base;
  const int codec = RAW ? a.dtype : -1;
  const uint32_t first = (threadIdx.x >> 5) * 32 * ITEMS + (threadIdx.x & 31);
  // buffers picked by branches, not by a runtime index into the parameter
  // struct (which would copy it to the stack)
  const bool odd_in = pass == 2;  // pass p reads kbuf[(p - 1) & 1]
  const uint32_t* kin = pass == 0 ? a.src : (odd_in ? a.kbuf[1] : a.kbuf[0]);
  const uint32_t* iin = odd_in ? a.ibuf[1] : a.ibuf[0];
  uint32_t k[ITEMS], ix[ITEMS];
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t pos = first + c * 32;
    k[c] = 0xFFFFFFFFu;
    ix[c] = base + pos;
    if (pos < n) {
      k[c] = pass == 0 && codec < 0 ? enc_key(a.dtype, kin[rb + pos]) : kin[rb + pos];
      if (KV && pass > 0) ix[c] = iin[rb + pos];
      if (KV && pass == 0 && codec >= 0) ix[c] = a.vals[rb + pos];
    }
  }
  uint32_t rk[(ITEMS + 1) / 2];
  rank_digits<W, ITEMS>(k, shift, codec, n, cnt, gsum, total, rk, mbins);
  volatile uint32_t* st = status + (size_t)row * tiles_per_row * 256;
  const bool last = t + 1 == tiles_per_row;
  if (threadIdx.x < 256 && !last)  // publish this tile's counts at once
    st[t * 256 + threadIdx.x] =
        (t == 0 ? kInclusive : kAggregate) | total[threadIdx.x];
  scan_digits(total, start, wsum);
  place_local<W, ITEMS, KV>(k, ix, rk, shift, codec, n, cnt, gsum, start,
                            skey, sidx);
  if (threadIdx.x < 256) {  // decoupled look-back, one digit a thread
    const uint32_t d = threadIdx.x;
    uint32_t excl = 0;
    for (int j = (int)t - 1; j >= 0; --j) {
      uint32_t v;
      do {
        v = st[j * 256 + d];
      } while (v == 0u);
      excl += v & kCountMask;
      if (v & kInclusive) break;
    }
    if (t > 0 && !last) st[t * 256 + d] = kInclusive | (excl + total[d]);
    gofs[d] = offs[((size_t)row * 4 + pass) * 256 + d] + excl - start[d];
  }
  __syncthreads();
  uint32_t* kout = (pass & 1) ? a.kbuf[1] : a.kbuf[0];
  uint32_t* iout = (pass & 1) ? a.ibuf[1] : a.ibuf[0];
  const size_t ro = (size_t)row * a.width;
  for (uint32_t j = threadIdx.x; j < n; j += W * 32) {
    const uint32_t key = skey[j];
    const uint32_t dst = gofs[digit_of(key, shift, codec)] + j;
    if (pass < 3) {
      kout[ro + dst] = key;
      if (KV) iout[ro + dst] = sidx[j];
    } else {
      write_out(a, row, dst, key, KV ? sidx[j] : 0u);
    }
  }
}

template <bool KV, bool RAW>
cudaError_t onesweep_passes(const SortArgs& a, uint32_t tpr,
                            const uint32_t* offs, uint32_t* counter,
                            uint32_t* status, size_t per_pass,
                            cudaStream_t st) {
  constexpr size_t smem = onesweep_smem<KV>();
  cudaError_t err = cudaFuncSetAttribute(
      onesweep_kernel<KV, RAW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  for (int p = 0; p < 4; ++p) {
    onesweep_kernel<KV, RAW><<<a.rows * tpr, kLongWarps * 32, smem, st>>>(
        a, p, tpr, offs, counter + p, status + p * per_pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// `scratch`: zeroed uint32 words, as kernels/tile_sort.py's
// onesweep_scratch_words counts them: per-row digit counts (rows × 4 × 256),
// four tile counters, then four passes of one look-back status word per
// tile and digit.
template <bool KV>
cudaError_t launch_onesweep(const SortArgs& a, uint32_t* scratch,
                            cudaStream_t st) {
  const uint32_t tpr = (a.width + kLongTile - 1) / kLongTile;
  uint32_t chunk = kHistChunk;
  while (chunk > kHistMinChunk &&
         (uint64_t)a.rows * ((a.width + chunk - 1) / chunk) < kHistBlocks)
    chunk >>= 1;
  const uint32_t chunks = (a.width + chunk - 1) / chunk;
  if ((uint64_t)a.rows * tpr >= (1ull << 31)) return cudaErrorInvalidValue;
  uint32_t* counts = scratch;
  uint32_t* counter = scratch + (size_t)a.rows * 1024;
  uint32_t* status = counter + 4;
  const size_t per_pass = (size_t)a.rows * tpr * 256;
  histogram_kernel<<<a.rows * chunks, kHistThreads, 0, st>>>(
      a.src, a.dtype, a.width, chunk, chunks, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  digit_scan_kernel<<<a.rows, 256, 0, st>>>(counts, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (KV) {
    if (a.mode == kGather)
      return onesweep_passes<true, true>(a, tpr, counts, counter, status,
                                         per_pass, st);
  }
  return onesweep_passes<KV, false>(a, tpr, counts, counter, status, per_pass,
                                    st);
}

// cap > 0: the resident kernel of that capacity; cap == 0: onesweep.
template <bool KV>
cudaError_t radix_rows(const SortArgs& a, int cap, uint32_t* scratch,
                       cudaStream_t st) {
  if (cap > 0) return launch_resident<KV>(a, cap, st);
  return launch_onesweep<KV>(a, scratch, st);
}

}  // namespace hk

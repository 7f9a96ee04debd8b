// Batched histogram merge (paper Algorithm 1) in two regimes.
//
// Replaces `merge_cut_kernel` (src/repro/kernels/merge_cut.py:46, wrapper
// `merge_pallas`), which fuses kv sort → prefix sum → cut count → gathers
// on one VMEM-resident problem.  Here a batch of Q problems, each k summaries
// of T buckets: L_real = k(T+1) boundaries, their masses (a bucket's size
// at its left boundary, 0 at each summary's last boundary), and β output
// buckets.  Both regimes compute exactly ref.merge_ref:
//
//   cum   = the inclusive sum of the masses in (boundary, flat index) order
//   cut_j = #{m < L_real-1 : cum[m] <= t_j},  t_j = j · (n / β) in float32
//   bo_j  = the boundary at sorted position cut_j (0 and L_real-1 at the
//           ends), gathered through its flat index with its own bits
//           (f32 or i32; -0, NaN payloads and ±inf kept)
//   so_j  = full_{j+1} - full_j,  full_j = cum[cut_j - 1] (0 when the cut
//           is 0; 0 and n at the ends)
//
//   resident  L_real <= 16,384 (tile_sort.plan(L_real, kv=True) > 0): ONE
//             launch, one block a problem, at the kv sort's resident
//             capacities.  The block loads its boundaries as encoded keys
//             with their flat index, runs the four radix passes of
//             radix_sort.cuh (resident_passes) in shared memory, scans the
//             masses in sorted order into a float32 cum that overwrites the
//             sorted keys, finds each cut by one binary search there (its
//             full value from the same search), and writes β+1 boundaries
//             and β sizes.  No (Q, L) array touches device memory.
//             Bound: 4·L_real (boundaries) + 4·kT (sizes) + 4·(2β+1)
//             (outputs) bytes a problem.
//   long      longer problems: argsort_pairs (kv_sort.cu, onesweep) writes
//             the sorted (key << 32 | index) pairs, (Q, L) with L the next
//             power of two, and ONE scan-and-cut launch follows, one block
//             a problem.  Pass A reads the pairs once, 16 bytes (two pairs)
//             a lane, and keeps one running total per group of gsz >= 64
//             keys in shared memory (at most 4,096 groups: 32 KB with their
//             bases).  A block scan turns them into the cum before and
//             after each group.  Each cut is one warp: a binary search over
//             the groups' ends, then a rescan of its one group from global
//             memory with exactly the arithmetic of pass A, so every cum
//             value the search compares, and every full value it returns,
//             is the one pass A summed.  No cum array exists.
//             Bound of the scan and cut: 8 B of pairs + 4 B of gathered
//             mass a key, 12·L bytes a problem (≈ 0.235 ms at Q=1000,
//             L=65,536 on the H100's 3.35 TB/s); the sort's own is in
//             radix_sort.cuh.
//
// A key's group, chunk and lane decide the order of its additions
// (warp_incl below); below 2^24 total mass every partial sum is an exact
// integer, so any order gives ref.merge_ref's bits.  Above it the cum is
// still searched self-consistently: full_j <= t_j always.
// The summary of a flat index is index / (T+1), by a multiply with a
// precomputed magic number (Divider), not a division.
#include "radix_sort.cuh"

namespace {

// floor(x / d) for x < 2^31 and 2 <= d <= 2^31: (x · M) >> (32 + l) with
// l = ceil(log2 d), M = ceil(2^(32+l) / d) <= 2^33, so x · M < 2^64;
// exact because x · d < 2^(32+l) (kernels/merge_cut.py: magic).
struct Divider {
  unsigned long long M;
  uint32_t shift;
};

Divider make_divider(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long p = 1ull << (32 + l);
  return Divider{(p + d - 1) / d, 32 + l};
}

__device__ __forceinline__ uint32_t divide(uint32_t x, const Divider& dv) {
  return (uint32_t)(((unsigned long long)x * dv.M) >> dv.shift);
}

struct MergeArgs {
  const uint4* order;     // long: (Q, L) pairs, two a uint4
  const uint32_t* bounds;  // (Q, L_real) 4-byte boundaries
  const float* sizes;      // (Q, k, T)
  uint32_t* bo;            // (Q, β+1), the boundaries' dtype
  float* so;               // (Q, β)
  uint32_t k, T, lreal, L, beta, gsz, ngroups;
  int dtype;
  Divider dv;              // by T+1
};

// mass of the element with flat index idx: sizes[src, b] at a bucket's
// left boundary, 0 at a summary's last boundary and past L_real (padding)
__device__ __forceinline__ float mass_of(const MergeArgs& a, const float* sz,
                                         uint32_t idx) {
  if (idx >= a.lreal) return 0.0f;
  const uint32_t src = divide(idx, a.dv), b = idx - src * (a.T + 1);
  return b < a.T ? __ldg(sz + (size_t)src * a.T + b) : 0.0f;
}

// Hillis–Steele inclusive scan over the warp's lanes (IEEE adds, no
// contraction): the one association of every in-warp sum below.
__device__ __forceinline__ float warp_incl(float v, uint32_t lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= (uint32_t)d) v = __fadd_rn(v, up);
  }
  return v;
}

// ---- resident regime ------------------------------------------------------

// Shared memory of the resident merge: exactly the resident kv sort's
// (hk::resident_smem<W, ITEMS, true>).  After the sort, cum overwrites the
// sorted keys; the W warp totals and the β-round buffer of full values
// (W·32 + 1 floats) take the digit counters' W·256 words.
template <int W, int ITEMS>
constexpr size_t merge_smem() {
  return hk::resident_smem<W, ITEMS, true>();
}

template <int W, int ITEMS>
__global__ void __launch_bounds__(W * 32) resident_merge_kernel(MergeArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr uint32_t C = W * 32 * ITEMS, NT = W * 32;
  static_assert(32 + NT + 1 <= W * 256, "warp totals and fulls fit the counters");
  const uint32_t q = blockIdx.x, n = a.lreal, tid = threadIdx.x;
  const uint32_t w = tid >> 5, lane = tid & 31;
  const uint32_t first = w * 32 * ITEMS + lane;
  const uint32_t* src = a.bounds + (size_t)q * n;
  uint32_t k[ITEMS], ix[ITEMS];
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t pos = first + c * 32;
    k[c] = 0xFFFFFFFFu;
    ix[c] = pos;
    if (pos < n) k[c] = hk::enc_key(a.dtype, src[pos]);
  }
  hk::resident_passes<W, ITEMS, true>(k, ix, n, -1, sm);
  const uint32_t* sidx = sm + C;
  float* cum = reinterpret_cast<float*>(sm);
  float* wtot = reinterpret_cast<float*>(sm + 2 * C);
  float* fbuf = wtot + 32;
  // scan: masses in sorted order; each warp owns 32·ITEMS positions, in
  // chunks of 32, carried; then the warps' totals
  const float* sz = a.sizes + (size_t)q * a.k * a.T;
  float m[ITEMS];
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t pos = first + c * 32;
    m[c] = pos < n ? mass_of(a, sz, sidx[pos]) : 0.0f;
  }
  float carry = 0.0f;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const float v = warp_incl(m[c], lane);
    m[c] = __fadd_rn(carry, v);
    carry = __fadd_rn(carry, __shfl_sync(0xFFFFFFFFu, v, 31));
  }
  if (lane == 0) wtot[w] = carry;
  __syncthreads();
  if (w == 0) {
    float x = lane < (uint32_t)W ? wtot[lane] : 0.0f;
    x = warp_incl(x, lane);
    if (lane < (uint32_t)W) wtot[lane] = x;
  }
  __syncthreads();
  const float off = w ? wtot[w - 1] : 0.0f;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const uint32_t pos = first + c * 32;
    if (pos < n) cum[pos] = __fadd_rn(off, m[c]);
  }
  __syncthreads();
  // cuts: output boundaries j = 1..β in rounds of NT, one thread and one
  // binary search each; the sizes of a round from its fulls
  const float total = cum[n - 1];
  const float step = __fdiv_rn(total, (float)a.beta);
  uint32_t* bo = a.bo + (size_t)q * (a.beta + 1);
  float* so = a.so + (size_t)q * a.beta;
  if (tid == 0) {
    bo[0] = src[sidx[0]];
    fbuf[0] = 0.0f;
  }
  for (uint32_t j0 = 0; j0 < a.beta; j0 += NT) {
    const uint32_t j = j0 + 1 + tid;
    if (j <= a.beta) {
      uint32_t at = n - 1;
      float full = total;
      if (j < a.beta) {
        const float t = __fmul_rn((float)j, step);
        uint32_t lo = 0, hi = n - 1;
        while (lo < hi) {
          const uint32_t mid = (lo + hi) >> 1;
          if (cum[mid] <= t) lo = mid + 1; else hi = mid;
        }
        at = lo;
        full = lo > 0 ? cum[lo - 1] : 0.0f;
      }
      fbuf[tid + 1] = full;
      bo[j] = src[sidx[at]];
    }
    __syncthreads();
    if (j <= a.beta) so[j - 1] = __fsub_rn(fbuf[tid + 1], fbuf[tid]);
    __syncthreads();
    if (tid == 0) fbuf[0] = fbuf[NT];
    __syncthreads();
  }
}

template <int W, int ITEMS>
cudaError_t run_resident_merge(const MergeArgs& a, uint32_t Q, cudaStream_t st) {
  constexpr size_t smem = merge_smem<W, ITEMS>();
  static_assert(smem <= 232448, "a block may use 227 KB of shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      resident_merge_kernel<W, ITEMS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  resident_merge_kernel<W, ITEMS><<<Q, W * 32, smem, st>>>(a);
  return cudaGetLastError();
}

// The kv sort's resident capacities (launch_resident in radix_sort.cuh),
// each the same block shape.
cudaError_t launch_resident_merge(const MergeArgs& a, uint32_t Q, int cap,
                                  cudaStream_t st) {
  if (a.lreal > (uint32_t)cap) return cudaErrorInvalidValue;
  switch (cap) {
    case 256: return run_resident_merge<8, 1>(a, Q, st);
    case 512: return run_resident_merge<8, 2>(a, Q, st);
    case 1024: return run_resident_merge<8, 4>(a, Q, st);
    case 2048: return run_resident_merge<8, 8>(a, Q, st);
    case 4096: return run_resident_merge<8, 16>(a, Q, st);
    case 8192: return run_resident_merge<16, 16>(a, Q, st);
    case 16384: return run_resident_merge<32, 16>(a, Q, st);
    default: break;
  }
  return cudaErrorInvalidValue;
}

// ---- long regime ----------------------------------------------------------

constexpr int kLongThreads = 1024;
constexpr int kLongWarps = kLongThreads / 32;
constexpr uint32_t kChunk = 64;          // keys a warp scans at once: 2 a lane
constexpr uint32_t kMaxGroups = 4096;    // group totals a block keeps
constexpr uint32_t kCutRound = 1024;     // output boundaries a round
constexpr int kGroupsInFlight = 4;       // pass A: groups a warp loads at once

// shared memory of a long block: group bases and ends, the round's fulls,
// the warps' totals (kernels/merge_cut.py: long_smem_bytes)
size_t long_smem(uint32_t ngroups) {
  return sizeof(float) * (2 * (size_t)ngroups + kCutRound + 1 + 32);
}

__device__ __forceinline__ uint4 load_pairs(const uint4* row, uint32_t m,
                                            uint32_t L) {
  // positions m, m+1 (m even); past L an index no mass belongs to
  return m < L ? __ldg(row + (m >> 1))
               : make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
}

// One chunk's cum values, as both pass A (its total) and the rescan (its
// elements) compute them: lane l holds positions 2l and 2l+1.
struct ChunkSums {
  float incl, excl, m0;
};

__device__ __forceinline__ ChunkSums chunk_sums(const MergeArgs& a,
                                                const float* sz, uint4 p,
                                                uint32_t lane) {
  const float m0 = mass_of(a, sz, p.x), m1 = mass_of(a, sz, p.z);
  const float incl = warp_incl(__fadd_rn(m0, m1), lane);
  float excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) excl = 0.0f;
  return ChunkSums{incl, excl, m0};
}

__global__ void __launch_bounds__(kLongThreads)
    long_merge_kernel(MergeArgs a) {
  extern __shared__ __align__(16) float fsm[];
  float* gbase = fsm;                  // cum before each group
  float* gend = fsm + a.ngroups;       // cum after each group
  float* fbuf = gend + a.ngroups;      // kCutRound + 1 fulls
  float* wsum = fbuf + kCutRound + 1;  // kLongWarps (<= 32) totals
  const uint32_t q = blockIdx.x, tid = threadIdx.x;
  const uint32_t w = tid >> 5, lane = tid & 31;
  const uint4* row = a.order + (size_t)q * (a.L >> 1);
  const float* sz = a.sizes + (size_t)q * a.k * a.T;
  const uint32_t* src = a.bounds + (size_t)q * a.lreal;
  // pass A: each group's total into gbase, several groups a warp in
  // flight; the block's warps walk the row side by side (this beat a
  // contiguous run of groups a warp, and 512 threads a block)
  for (uint32_t g0 = w * kGroupsInFlight; g0 < a.ngroups;
       g0 += kLongWarps * kGroupsInFlight) {
    float carry[kGroupsInFlight];
#pragma unroll
    for (int u = 0; u < kGroupsInFlight; ++u) carry[u] = 0.0f;
    for (uint32_t ch = 0; ch < a.gsz; ch += kChunk) {
      uint4 p[kGroupsInFlight];
#pragma unroll
      for (int u = 0; u < kGroupsInFlight; ++u) {
        const uint32_t g = g0 + u;
        p[u] = load_pairs(row, (g < a.ngroups ? g * a.gsz : a.L) + ch + 2 * lane, a.L);
      }
#pragma unroll
      for (int u = 0; u < kGroupsInFlight; ++u) {
        const ChunkSums s = chunk_sums(a, sz, p[u], lane);
        carry[u] = __fadd_rn(carry[u], __shfl_sync(0xFFFFFFFFu, s.incl, 31));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kGroupsInFlight; ++u)
        if (g0 + u < a.ngroups) gbase[g0 + u] = carry[u];
    }
  }
  __syncthreads();
  // block scan of the group totals: a run of groups a thread, in order
  {
    const uint32_t per = (a.ngroups + kLongThreads - 1) / kLongThreads;
    const uint32_t gb = min(tid * per, a.ngroups), ge = min(gb + per, a.ngroups);
    float sum = 0.0f;
    for (uint32_t g = gb; g < ge; ++g) sum = __fadd_rn(sum, gbase[g]);
    const float incl = warp_incl(sum, lane);
    float excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (lane == 31) wsum[w] = incl;
    __syncthreads();
    if (w == 0) {
      float x = lane < (uint32_t)kLongWarps ? wsum[lane] : 0.0f;
      x = warp_incl(x, lane);
      if (lane < (uint32_t)kLongWarps) wsum[lane] = x;
    }
    __syncthreads();
    sum = __fadd_rn(w ? wsum[w - 1] : 0.0f, excl);
    for (uint32_t g = gb; g < ge; ++g) {
      const float t = gbase[g];
      gbase[g] = sum;
      sum = __fadd_rn(sum, t);
      gend[g] = sum;
    }
  }
  __syncthreads();
  // cuts: one warp an output boundary, in rounds of kCutRound
  const float total = gend[a.ngroups - 1];
  const float step = __fdiv_rn(total, (float)a.beta);
  uint32_t* bo = a.bo + (size_t)q * (a.beta + 1);
  float* so = a.so + (size_t)q * a.beta;
  if (tid == 0) {
    bo[0] = src[__ldg(row).x];
    fbuf[0] = 0.0f;
  }
  for (uint32_t j0 = 0; j0 < a.beta; j0 += kCutRound) {
    const uint32_t jn = min(a.beta - j0, kCutRound);
    for (uint32_t i = w; i < jn; i += kLongWarps) {
      const uint32_t j = j0 + 1 + i;
      float full = total;
      uint32_t idx;
      if (j == a.beta) {
        const uint4 p = __ldg(row + ((a.lreal - 1) >> 1));
        idx = (a.lreal - 1) & 1 ? p.z : p.x;
      } else {
        const float t = __fmul_rn((float)j, step);
        // the first group whose end passes t, or that holds L_real - 1
        uint32_t lo = 0, hi = a.ngroups - 1;
        while (lo < hi) {
          const uint32_t mid = (lo + hi) >> 1;
          if (gend[mid] > t || (mid + 1) * a.gsz >= a.lreal) hi = mid; else lo = mid + 1;
        }
        const float base = gbase[lo];
        float prev = lo ? gend[lo - 1] : 0.0f, carry = 0.0f;
        idx = 0xFFFFFFFFu;
        for (uint32_t ch = 0; ch < a.gsz; ch += kChunk) {
          const uint32_t m = lo * a.gsz + ch + 2 * lane;
          const uint4 p = load_pairs(row, m, a.L);
          const ChunkSums s = chunk_sums(a, sz, p, lane);
          const float c0 = __fadd_rn(base, __fadd_rn(carry, __fadd_rn(s.excl, s.m0)));
          const float c1 = __fadd_rn(base, __fadd_rn(carry, s.incl));
          const bool gt0 = m >= a.lreal - 1 || c0 > t;
          const bool gt1 = m + 1 >= a.lreal - 1 || c1 > t;
          const uint32_t hit = __ballot_sync(0xFFFFFFFFu, gt0 || gt1);
          const float last = __shfl_sync(0xFFFFFFFFu, c1, 31);
          if (hit) {
            const uint32_t f = __ffs(hit) - 1;
            const bool at0 = __shfl_sync(0xFFFFFFFFu, (int)gt0, f);
            const float c0f = __shfl_sync(0xFFFFFFFFu, c0, f);
            const float c1b = __shfl_sync(0xFFFFFFFFu, c1, (f + 31) & 31);
            const uint32_t i0 = __shfl_sync(0xFFFFFFFFu, p.x, f);
            const uint32_t i1 = __shfl_sync(0xFFFFFFFFu, p.z, f);
            idx = at0 ? i0 : i1;
            full = at0 ? (f ? c1b : prev) : c0f;
            break;
          }
          prev = last;
          carry = __fadd_rn(carry, __shfl_sync(0xFFFFFFFFu, s.incl, 31));
        }
      }
      if (lane == 0) {
        fbuf[i + 1] = full;
        bo[j] = src[idx];
      }
    }
    __syncthreads();
    for (uint32_t i = tid; i < jn; i += kLongThreads)
      so[j0 + i] = __fsub_rn(fbuf[i + 1], fbuf[i]);
    __syncthreads();
    if (tid == 0) fbuf[0] = fbuf[jn];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bounds (Q, k, T+1) with a 4-byte dtype (hk::kF32 / kI32), sizes (Q, k, T)
// float32; outputs bo (Q, β+1) in the bounds' dtype and so (Q, β) float32.
// cap > 0: the resident merge of that capacity (order unused); cap == 0:
// the long merge's scan and cut over order (Q, L), argsort_pairs' pairs.
int hk_merge_cut(const void* order, const void* bounds, const float* sizes,
                 int Q, int k, int T, int L, int beta, int dtype, int cap,
                 void* bo, float* so, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || k < 1 || T < 1 || beta < 1) return (int)cudaErrorInvalidValue;
  const unsigned long long lreal = (unsigned long long)k * (T + 1);
  if (lreal >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  MergeArgs a{};
  a.order = static_cast<const uint4*>(order);
  a.bounds = static_cast<const uint32_t*>(bounds);
  a.sizes = sizes;
  a.bo = static_cast<uint32_t*>(bo);
  a.so = so;
  a.k = (uint32_t)k;
  a.T = (uint32_t)T;
  a.lreal = (uint32_t)lreal;
  a.beta = (uint32_t)beta;
  a.dtype = dtype;
  a.dv = make_divider((uint32_t)T + 1);
  if (cap > 0) return (int)launch_resident_merge(a, (uint32_t)Q, cap, st);
  if (L < 2 || (L & (L - 1)) || (uint32_t)L < a.lreal) return (int)cudaErrorInvalidValue;
  a.L = (uint32_t)L;
  a.gsz = kChunk;
  while (a.L / a.gsz > kMaxGroups) a.gsz <<= 1;
  a.ngroups = (a.L + a.gsz - 1) / a.gsz;
  const size_t smem = long_smem(a.ngroups);
  cudaError_t err = cudaFuncSetAttribute(
      long_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  long_merge_kernel<<<(unsigned)Q, kLongThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

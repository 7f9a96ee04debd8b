// Bucket count: the cumulative counts #(x < b_j), j = 0..T, and #(x == b_T)
// of a float32 value stream against fixed histogram boundaries.
//
// Replaces `bucket_count_kernel` (src/repro/kernels/bucket_count.py:35,
// wrapper `cumulative_counts_pallas`), which compares every staged tile of
// the stream against all T+1 boundaries at once — n·(T+1) compares, cheap
// on the TPU's vector unit — and accumulates float32 partial counts across
// its sequential grid.  Here each value is placed by a search over the
// boundaries instead: p = #(b_j <= x) over the sorted non-NaN prefix of the
// boundaries (m of them), so that x < b_j  <=>  p <= j.  A block keeps a
// histogram of p in shared memory (32-bit: a block counts fewer than 2^31
// values), scans it, and adds its own cumulative counts into the output
// with 64-bit atomics; the output is zeroed first, so the sum over blocks
// is the answer.  Counts are integers throughout: exact at any stream
// length, where the reference's float32 sums stop being exact above 2^24.
//
// Semantics are IEEE compares, as the reference's: NaN values are never
// counted (they compare false), -0 == +0, and +inf counts in the last slot
// when b_T = +inf.  NaN boundaries (a partition that held NaN) end the
// boundary vector; x < NaN is false, so their slots count 0 and the search
// covers only the prefix before them: m boundaries, which each block
// counts as it builds its table, so that the launch needs nothing from the
// host but T+1.  The wrapper rejects unsorted boundaries from a copy it
// reads back while the kernel runs.  The stream is never padded, so
// nothing but the n real values is counted.
//
// Bound: device-memory bytes, 4n to read the stream once (the boundaries
// and the counts are a few KB).  Shared memory is a near co-bound: a value
// costs d = ceil(log2(T + 2)) table loads and one histogram atomic, some
// ten shared-memory wavefronts a warp of 32 values.  What the design does
// about both:
//
//   - loads: a thread reads four 16-byte vectors (16 values) a round through
//     the read-only path, the first round's while the block builds its
//     table, and one thread asks L2 for the block's next round (one bulk
//     prefetch of 32 KB) before the block searches this one; a scalar head
//     brings x to 16-byte alignment (a view may start at any float) and a
//     scalar tail takes the last n mod 4;
//   - search: each block lays the boundaries out in BFS (Eytzinger) order
//     in shared memory, e[1 .. 2^d - 1] with d = ceil(log2(T+2)), node i at
//     level k = floor(log2 i) holding sorted position
//     (2(i - 2^k) + 1)·2^(d-1-k) - 1, or +inf past m (NaN boundaries and
//     the padding past T+1 alike), eight loads a thread in flight.
//     Exactly d steps of i = 2i + !(e[i] > v) give p = i - 2^d: no lane
//     diverges, the 16 searches of a thread interleave, a step is four
//     instructions, and the top six levels lie in 63 consecutive words (no
//     bank conflict).  For a number v, p = #(b_j <= v) <= m (+inf nodes move
//     only v = +inf right); NaN moves right at every node, so p >= m, and a
//     value with p >= m counts only as #(v == b_T);
//   - histogram: a thread adds runs of equal slots of its consecutive values
//     with one atomic, and each warp has its own histogram where that fits
//     in kPerWarpShared, so a stream of one value costs no more than a
//     spread one;
//   - registers: one 512-thread block an SM, so that a thread may hold
//     its sixteen values and their sixteen search positions in registers
//     (capped at 64 for two blocks an SM, the compiler scheduled the
//     searches worse; measured slower at the main path's small shapes);
//   - launches: the wrapper sizes the grid to the work (kernels/
//     bucket_count.py, `grid`): full rounds of four float4s a thread when
//     the stream is large, else one short round a block, so that a small
//     call still spreads over the card (a warp searches only its loads
//     inside the round); a call is one memset (the output) and one
//     kernel, and no block waits on another;
//   - the blocks' adds: every block adds into every slot of the output,
//     so with several slots a thread each block adds its staged counts
//     from its own starting slot, and blocks do not queue on one address
//     after another.
//
// Boundary vectors whose table and one histogram do not fit shared memory
// (T+1 > 25,087: 2^15 table floats and T+2 slots pass kMaxShared) are
// searched in place in global memory (L2-resident), with a number of steps
// that depends on m alone, and counted in passes of at most kChunk slots:
// a pass counts the block's values whose slot lies in it, and carries the
// block's total of the slots before it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // kernels/bucket_count.py: THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 1;  // kernels/bucket_count.py: BLOCKS_PER_SM
constexpr int kVec = 4;          // float4 loads a thread a round, at most
constexpr int kRound = kThreads * kVec;  // float4s a block counts a round, at most
constexpr size_t kMaxShared = 232448 - 1024;  // 227 KB, less the static words
constexpr size_t kPerWarpShared = 64 * 1024;  // per-warp histograms only up to here
constexpr int kChunk = (int)(kMaxShared / sizeof(unsigned int));  // slots a pass
constexpr int kBuildLoads = 8;  // table loads a thread has in flight
constexpr int kNone = -1;       // a value that counts in no slot

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// this thread's 4·kVec values of the round of `len` float4s at float4
// `base` (float4 base + k·kThreads + thread, k < kVec); NaN (never counted)
// past the round or past the q whole float4s.  Only a short round and the
// last round of the stream need the bounds check.
__device__ __forceinline__ void load_round(const float4* __restrict__ x4, long long q,
                                           long long base, int len, float (&v)[4 * kVec]) {
  const bool whole = len == kRound && base + kRound <= q;  // the same for the whole block
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int o = k * kThreads + threadIdx.x;
    const long long i = base + o;
    const float4 f = whole || (o < len && i < q)
                         ? __ldg(&x4[i])
                         : make_float4(nan_f(), nan_f(), nan_f(), nan_f());
    v[4 * k] = f.x;
    v[4 * k + 1] = f.y;
    v[4 * k + 2] = f.z;
    v[4 * k + 3] = f.w;
  }
}

// ask L2 for the block's full round at float4 `base` (one bulk request)
__device__ __forceinline__ void prefetch_round(const float4* x4, long long q, long long base) {
  if (base >= q) return;
  const long long len = q - base < kRound ? q - base : kRound;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(x4 + base),
               "r"((unsigned)(len * sizeof(float4)))
               : "memory");
}

// p[j] by d steps down the BFS table at shared address e (1-indexed):
// p = #(b <= v) for a number v, and p >= m for NaN (no node is greater).
// a = e + 4i is node i's address, so a step i = 2i + !(e[i] > v) is one
// load, one compare, one select and one multiply-add.
template <int N>
__device__ __forceinline__ void search_bfs(unsigned e, int d, const float* v, int* p) {
  const unsigned left = 0u - e, right = 4u - e;
  unsigned a[N];
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = e + 4u;
  for (int s = 0; s < d; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float node;
      asm volatile("ld.shared.f32 %0, [%1];" : "=f"(node) : "r"(a[j]));
      a[j] = 2u * a[j] + (node > v[j] ? left : right);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = (int)((a[j] - e) >> 2) - (1 << d);
}

// the same p over the sorted b[0..m) in global memory: the steps halve len,
// so their number depends on m alone
template <int N>
__device__ __forceinline__ void search_sorted(const float* __restrict__ b, int m, const float* v,
                                              int* p) {
  int lo[N];
#pragma unroll
  for (int j = 0; j < N; ++j) lo[j] = 0;
  for (int len = m; len > 1; len -= len >> 1) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < N; ++j) lo[j] += __ldg(&b[lo[j] + half]) > v[j] ? 0 : half;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = m ? lo[j] + !(__ldg(&b[lo[j]]) > v[j]) : 0;
}

template <bool kShared, int N>
__device__ __forceinline__ void search(const float* v, const float* b, unsigned e, int m, int d,
                                       int* p) {
  if (kShared) search_bfs<N>(e, d, v, p);
  else search_sorted<N>(b, m, v, p);
}

// slot of a value: p < top in slot p, p >= top only as #(v == b_T) in
// slot top (last = b_T, NaN when the boundaries end in NaN, and nothing
// equals NaN); NaN values (p >= m) nowhere.  top = m in global memory;
// in shared memory top = T1 >= m, a kernel argument, so that the block's
// own count m stays out of the counting loop: there p <= m for a number
// below +inf, and slot m, when m < T1, holds values that no output counts
__device__ __forceinline__ int slot_of(float v, int p, int top, float last) {
  return p < top ? p : (v == last ? top : kNone);
}

// add c to slot s if this pass holds it (slots lo .. hi)
__device__ __forceinline__ void add(unsigned int* hs, int lo, int hi, int s, unsigned int c) {
  if ((unsigned)(s - lo) < (unsigned)(hi - lo)) atomicAdd(&hs[s - lo], c);
}

// count N consecutive values of one thread: runs of one slot are one
// atomic.  kAll: search them all; else only the first 4·groups (the rest
// are NaN past a short round; groups is the same across a warp)
template <bool kShared, bool kAll, int N>
__device__ __forceinline__ void count_values(const float (&v)[N], int groups, const float* b,
                                             unsigned e, int top, int d, float last,
                                             int lo, int hi, unsigned int* hs) {
  int p[N];
  if (kAll) {
    search<kShared, N>(v, b, e, top, d, p);
  } else {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      if (k < groups) {
        search<kShared, 4>(v + 4 * k, b, e, top, d, p + 4 * k);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) p[4 * k + j] = top;
      }
    }
  }
  int cur = slot_of(v[0], p[0], top, last);
  unsigned int run = 1;
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const int s = slot_of(v[j], p[j], top, last);
    if (s != cur) {
      add(hs, lo, hi, cur, run);
      cur = s;
      run = 0;
    }
    ++run;
  }
  add(hs, lo, hi, cur, run);
}

// the block's count of slot lo + s over its W warp histograms
__device__ __forceinline__ unsigned long long slot_total(const unsigned int* h0, int W,
                                                         int stride, int s) {
  unsigned long long c = 0;
  for (int w = 0; w < W; ++w) c += h0[w * stride + s];
  return c;
}

// the block's m: the sum of its warps' counts of numbers among the boundaries
__device__ __forceinline__ int block_sum(const int* warp_m) {
  int m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m += warp_m[w];
  return m;
}

// add this block's cumulative counts of the pass's slots [lo, hi) to out:
// out[j] += carry + (its count of slots lo .. j) for j < m, out[T1] += its
// count of slot top.  Each thread takes consecutive slots; one block scan
// of the threads' totals.  Returns carry + the pass's total below m.
// Where a thread holds several slots and `stage` has room for them (the
// table, free once the block has counted), the counts are staged there
// and added from slot rot = block·S/blocks on, wrapping: every block adds
// into every slot, and blocks that started at one slot would queue on
// each address in turn.
__device__ unsigned long long flush(const unsigned int* h0, int W, int stride, int lo, int hi,
                                    int m, int top, int T1, unsigned long long carry,
                                    long long* __restrict__ out, unsigned int* stage) {
  __shared__ unsigned long long warp_tot[kWarps];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = min(hi, m) - lo;  // slots below m in this pass
  const int k = (S + kThreads - 1) / kThreads;
  const int s0 = min((int)threadIdx.x * k, S), s1 = min(s0 + k, S);
  unsigned long long own = 0;
  for (int s = s0; s < s1; ++s) own += slot_total(h0, W, stride, s);
  unsigned long long incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= (unsigned)d) incl += up;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < kWarps ? warp_tot[lane] : 0ull;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long up = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= (unsigned)d) w += up;
    }
    if (lane < kWarps) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  unsigned long long run = carry + incl - own + (warp > 0 ? warp_tot[warp - 1] : 0ull);
  if (stage == nullptr || k < 2) {
    for (int s = s0; s < s1; ++s) {
      run += slot_total(h0, W, stride, s);
      if (run) atomicAdd(reinterpret_cast<unsigned long long*>(&out[lo + s]), run);
    }
  } else {  // one pass in shared memory: a block's counts are below 2^31
    for (int s = s0; s < s1; ++s) {
      run += slot_total(h0, W, stride, s);
      stage[s] = (unsigned)run;
    }
    __syncthreads();
    const int rot = (int)((long long)blockIdx.x * S / gridDim.x);
    for (int j = threadIdx.x; j < S; j += kThreads) {
      const int s = j + rot < S ? j + rot : j + rot - S;
      if (stage[s]) atomicAdd(reinterpret_cast<unsigned long long*>(&out[lo + s]),
                              (unsigned long long)stage[s]);
    }
  }
  if (lo <= top && top < hi && threadIdx.x == 0) {
    const unsigned long long eq = slot_total(h0, W, stride, top - lo);
    if (eq) atomicAdd(reinterpret_cast<unsigned long long*>(&out[T1]), eq);
  }
  return carry + warp_tot[kWarps - 1];
}

// out (T1 + 1,) int64, zeroed.  x + head is 16-byte aligned; q = (n -
// head) / 4 whole float4s follow it, which the blocks count in rounds of
// len <= kRound float4s, block g the rounds g, g + gridDim.x, ...  kShared:
// the BFS table (2^d floats, d = ceil(log2(T1 + 1))) and W = per_warp ?
// kWarps : 1 histograms of T1 + 1 slots in shared memory, one pass.  Else
// the sorted b searched in global memory and one histogram of kChunk
// slots, a pass per kChunk slots.  The block counts m, the numbers among
// the boundaries, itself: the wrapper checks after the launch that they
// are a sorted prefix, so the launch waits on no read-back.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    count_kernel(const float* __restrict__ x, long long n, int head,
                 const float* __restrict__ b, int T1, int len, int per_warp,
                 long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_m[kWarps];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float last = b[T1 - 1];
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const long long q = (n - head) >> 2;
  const long long first = (long long)blockIdx.x * len;
  const long long step = (long long)gridDim.x * len;
  float v[4 * kVec];
  load_round(x4, q, first, len, v);  // in flight while the table is built

  int d = 0, mine = 0;  // mine: numbers among this thread's boundary loads
  unsigned e = 0;
  unsigned int* h0 = reinterpret_cast<unsigned int*>(smem);
  if (kShared) {
    float* tab = reinterpret_cast<float*>(smem);
    d = 32 - __clz(T1);  // ceil(log2(T1 + 1))
    const int nodes = 1 << d;
    for (int i0 = threadIdx.x + 1; i0 < nodes; i0 += kBuildLoads * kThreads) {  // tab[0] unused
      float t[kBuildLoads];
#pragma unroll
      for (int u = 0; u < kBuildLoads; ++u) {  // all loads out before the first store
        const int i = i0 + u * kThreads;
        t[u] = nan_f();
        if (i < nodes) {
          const int k = 31 - __clz(i);
          const int pos = ((2 * (i - (1 << k)) + 1) << (d - 1 - k)) - 1;
          if (pos < T1) t[u] = __ldg(&b[pos]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBuildLoads; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nodes) {
          const bool num = !isnan(t[u]);
          mine += num;
          tab[i] = num ? t[u] : inf_f();  // +inf past m and past T1
        }
      }
    }
    e = static_cast<unsigned>(__cvta_generic_to_shared(tab));
    h0 = reinterpret_cast<unsigned int*>(tab + nodes);
  } else {
    for (int i = threadIdx.x; i < T1; i += kThreads) mine += !isnan(__ldg(&b[i]));
  }
  const int W = per_warp ? kWarps : 1;
  const int stride = kShared ? T1 + 1 : kChunk;
  for (int i = threadIdx.x; i < W * stride; i += kThreads) h0[i] = 0u;
  mine = __reduce_add_sync(0xFFFFFFFFu, mine);
  if (lane == 0) warp_m[warp] = mine;
  __syncthreads();
  // m is read from warp_m where it is used, so that it holds no register
  // through the counting loop in shared memory
  const int top = kShared ? T1 : block_sum(warp_m);
  unsigned int* hs = h0 + (per_warp ? (int)warp * stride : 0);

  unsigned long long carry = 0;
  for (int lo = 0; lo <= top; lo += stride) {
    const int hi = lo + stride;
    if (lo > 0) {  // a later pass zeroes its slots and reads the values again
      for (int i = threadIdx.x; i < W * stride; i += kThreads) h0[i] = 0u;
      __syncthreads();
      load_round(x4, q, first, len, v);
    }
    if (len == kRound) {  // full rounds
      for (long long base = first; base < q; base += step) {
        if (threadIdx.x == 0) prefetch_round(x4, q, base + step);
        count_values<kShared, true>(v, kVec, b, e, top, d, last, lo, hi, hs);
        if (base + step < q) load_round(x4, q, base + step, kRound, v);
      }
    } else {  // short rounds (one a block, as the wrapper sizes them): a warp
              // searches only its loads that lie inside the round
      int groups = 0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) groups += k * kThreads + (int)warp * 32 < len;
      for (long long base = first; base < q; base += step) {
        count_values<kShared, false>(v, groups, b, e, top, d, last, lo, hi, hs);
        if (base + step < q) load_round(x4, q, base + step, len, v);
      }
    }
    if (blockIdx.x == 0 && threadIdx.x < 8) {  // the head (< 4) and the tail (< 4)
      const long long tail = head + 4 * q, t = (long long)threadIdx.x - 4;
      float u[1] = {nan_f()};
      if ((int)threadIdx.x < head) u[0] = x[threadIdx.x];
      else if (t >= 0 && tail + t < n) u[0] = x[tail + t];
      count_values<kShared, true>(u, 1, b, e, top, d, last, lo, hi, hs);
    }
    __syncthreads();
    carry = flush(h0, W, stride, lo, hi, block_sum(warp_m), top, T1, carry, out,
                  kShared ? reinterpret_cast<unsigned int*>(smem) : nullptr);
    __syncthreads();  // the histogram and warp_tot are reused by the next pass
  }
}

template <bool kShared>
cudaError_t launch(const float* x, long long n, int head, const float* b, int T1, int len,
                   int per_warp, int blocks, size_t smem, long long* out, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(count_kernel<kShared>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  count_kernel<kShared><<<(unsigned)blocks, kThreads, smem, st>>>(x, n, head, b, T1, len,
                                                                  per_warp, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n,) float32 (any 4-byte alignment); b (T1,) float32, T1 >= 2, which
// the wrapper checks (after the launch) to be non-decreasing numbers and
// then NaN only; out (T1 + 1,) int64.  blocks and len (float4s a block
// round, 1 .. kRound) from the wrapper's grid: at least 1 block, each
// counting fewer than 2^31 values.  n may be 0: out is then the zeros of
// the memset.
int hk_bucket_count(const float* x, long long n, const float* b, int T1, int blocks, int len,
                    long long* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(long long) * (size_t)(T1 + 1), st);
  if (err != cudaSuccess) return (int)err;
  long long head = (long long)((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / 4;
  if (head > n) head = n;
  int d = 0;
  while ((1ll << d) <= (long long)T1) ++d;  // ceil(log2(T1 + 1))
  const size_t table = sizeof(float) << d;
  const size_t one = table + sizeof(unsigned int) * (size_t)(T1 + 1);
  const size_t warps = table + sizeof(unsigned int) * (size_t)(T1 + 1) * kWarps;
  if (one <= kMaxShared) {  // T1 <= 25,087
    const int per_warp = warps <= kPerWarpShared;
    const size_t smem = per_warp ? warps : one;
    err = launch<true>(x, n, (int)head, b, T1, len, per_warp, blocks, smem, out, st);
  } else {
    const size_t smem = sizeof(unsigned int) * (size_t)kChunk;
    err = launch<false>(x, n, (int)head, b, T1, len, 0, blocks, smem, out, st);
  }
  return (int)err;
}

}  // extern "C"

// Grouped-query decode attention: one query token of each row against its
// layer's KV cache, read once, where it lies, in the dtype it is stored in.
//
// Replaces no TPU kernel.  The reference's decode attention
// (src/repro/models/common.py, `decode_attention`) is plain `jnp` that XLA
// fuses; the port's plain body (models/common.py,
// `plain_decode_attention`) instead casts the whole cache to float32,
// copies it into the einsum's batch layout and multiplies over every
// position, masked ones included: some ten times the cache's bytes a
// layer.  This kernel computes the same function with the same float32
// arithmetic (the scores (q·k)·hd^-0.5, the tanh softcap, a float32
// softmax and a float32 PV product, one rounding to q's dtype at the end);
// only the order of the sums differs.  Positions outside the visible range
// [lo, hi] (hi = min(position, Smax - 1), lo = max(0, position - window + 1))
// are skipped: the plain path gives them a -1e30 logit, whose weight is
// exactly 0 in float32.  Each block reads the position from device memory,
// so one launch, its grid and its arguments serve every position: a CUDA
// graph of the decode step replays it as the position advances on the card.
//
// Bound: device-memory bytes.  A K or V element of the visible range is
// read once (2 or 4 bytes) and takes 2·G float32 operations (G query heads
// share one KV head), about 4 operations a byte at G = 4 in bfloat16,
// far below the CUDA cores' ridge (67e12 / 3.35e12 = 20), so no tensor
// core is used.  What the design does about the bytes:
//
//   - one block a (split of the visible range, KV head, row): each block
//     holds the G query vectors of its KV head, so a K/V row is read once
//     for all G query heads (the GQA reuse);
//   - 16-byte streaming loads (`ld.global.cs`): a row of hd elements is
//     read by kTpr lanes of kE elements each, neighbouring lanes on
//     neighbouring 16-byte words, kRpw rows a warp at once; each lane keeps
//     kUnroll rows of K and V in flight (128 bytes), so that a block of 4
//     warps has 16 KB in flight and three or four blocks an SM hide the
//     memory's latency;
//   - the scores of a row are summed over its kTpr lanes by xor shuffles;
//     each lane keeps its own running max, sum and float32 accumulator of
//     its kE dimensions for G heads (online softmax), rescaled once per
//     kUnroll rows; the row groups of a warp, then the warps of the block
//     (in shared memory), are merged at the end;
//   - the lanes a row (kTpr, 4 to 32) follow from hd, G and the dtype, so
//     that the query and accumulator registers (2·GM·kE) stay at most 64
//     for G up to 4 (128 above) and a row group reads 64 bytes or more at
//     once: fewer lanes a row for small G mean fewer shuffles a row;
//   - the wrapper (kernels/gqa_decode.py, `plan`) cuts the widest visible
//     range, min(Smax, window) positions, into `splits` chunks of `chunk`
//     so that the grid runs several waves over the SMs; split s covers
//     [lo + s·chunk, min(hi, lo + (s + 1)·chunk - 1)] of the position's own
//     range, and one that starts past hi reads nothing; with more than one
//     split each block writes its (max, sum, accumulator) partials to
//     float32 scratch (an empty split: max -inf, sum 0, accumulator 0) and a
//     second small kernel merges them into the output, weighing an empty one
//     0; with one split the block writes the output itself.
//
// Templates: the KV dtype (bfloat16 or float32), hd (32, 64, 128, 256) and
// GM, the number of query heads a KV head rounded up to 1, 2, 4 or 8 (the
// heads past G are masked).  q and the output are bfloat16 or float32 at
// run time.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCombineThreads = 256;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The lanes of a row and what each holds (tests/test_torch_gqa_decode.py holds its invariants).
template <typename T, int HD, int GM>
struct Geo {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte load
  static constexpr int kE = cmax(HD / 32, cmin(cmax(kVec, 32 / GM), HD / 4));  // elements a lane a row
  static constexpr int kTpr = HD / kE;                 // lanes a row, 4 .. 32
  static constexpr int kRpw = 32 / kTpr;               // rows a warp reads at once
  static constexpr int kNc = kE / kVec;                // 16-byte loads a lane a row
  static constexpr int kUnroll = cmin(4, cmax(1, 64 / (kE * static_cast<int>(sizeof(T)))));
  static constexpr int kRows = kWarps * kRpw * kUnroll;  // rows a block iteration
};

__device__ __forceinline__ uint4 load_cs(const void* p) { return __ldcs(static_cast<const uint4*>(p)); }

// The float32 values of one 16-byte word of T (exact for bfloat16).
template <typename T>
__device__ __forceinline__ void widen(const uint4& u, float* f);

template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void widen<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ float load_q(const void* q, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]) : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, size_t i, float x, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(out)[i] = x;
  }
}

// exp(m - mx), 0 for a state that has seen no row (m = -inf)
__device__ __forceinline__ float rescale(float m, float mx) { return m == -INFINITY ? 0.f : expf(m - mx); }

struct Args {
  const void* q;   // (B, Hkv, G, hd), q_bf16 ? bfloat16 : float32
  const void* k;   // (B, Smax, Hkv, hd), the template's T
  const void* v;
  void* out;       // like q
  float* part;     // (B, Hkv, splits, G, hd + 2): accumulator, max, sum
  const int* pos;  // (1,): the position of the token being decoded
  int q_bf16, smax, hkv, g, window, chunk, splits;  // window 0: none
  float scale, cap;  // cap 0: no softcap
};

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  using G_ = Geo<T, HD, GM>;
  constexpr int kVec = G_::kVec, kE = G_::kE, kTpr = G_::kTpr, kRpw = G_::kRpw, kNc = G_::kNc,
                kUnroll = G_::kUnroll;
  __shared__ float sm_m[kWarps][GM], sm_l[kWarps][GM];
  __shared__ float sm_acc[kWarps][GM][HD];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / kTpr, sub = lane % kTpr;
  const int position = *a.pos;
  const int hi = min(position, a.smax - 1);
  const int lo = a.window > 0 ? max(0, position - a.window + 1) : 0;
  const int start = lo + split * a.chunk;
  const int end = min(hi, start + a.chunk - 1);  // below start: an empty split
  const size_t head = static_cast<size_t>(b) * a.hkv + kvh;  // (row, KV head)

  // this lane's kE dimensions: load c covers [(c·kTpr + sub)·kVec, +kVec)
  float qv[GM][kE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int d = (c * kTpr + sub) * kVec + j;
        qv[g][c * kVec + j] = g < a.g ? load_q(a.q, (head * a.g + g) * HD + d, a.q_bf16) : 0.f;
      }
    }
  }
  float m[GM], l[GM], acc[GM][kE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(a.hkv) * HD;  // elements between positions
  const T* kb = static_cast<const T*>(a.k) + static_cast<size_t>(b) * a.smax * row_stride + static_cast<size_t>(kvh) * HD;
  const T* vb = static_cast<const T*>(a.v) + static_cast<size_t>(b) * a.smax * row_stride + static_cast<size_t>(kvh) * HD;

  for (int base = start; base <= end; base += G_::kRows) {
    uint4 kr[kUnroll][kNc], vr[kUnroll][kNc];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + (u * kWarps + warp) * kRpw + rg;
      ok[u] = s <= end;
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        const size_t off = static_cast<size_t>(s) * row_stride + (c * kTpr + sub) * kVec;
        kr[u][c] = ok[u] ? load_cs(kb + off) : make_uint4(0, 0, 0, 0);
        vr[u][c] = ok[u] ? load_cs(vb + off) : make_uint4(0, 0, 0, 0);
      }
    }
    float sc[kUnroll][GM];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kE];
#pragma unroll
      for (int c = 0; c < kNc; ++c) widen<T>(kr[u][c], kf + c * kVec);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) dot = fmaf(qv[g][e], kf[e], dot);
#pragma unroll
        for (int off = kTpr / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float x = dot * a.scale;
        if (a.cap != 0.f) x = a.cap * tanhf(x / a.cap);
        sc[u][g] = ok[u] ? x : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][g]);
      if (mx == -INFINITY) continue;  // no visible row yet in this lane's rows
      const float corr = rescale(m[g], mx);
      float p[kUnroll];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = expf(sc[u][g] - mx);  // 0 for a row past the end
        psum += p[u];
      }
      l[g] = l[g] * corr + psum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vf[kE];
#pragma unroll
        for (int c = 0; c < kNc; ++c) widen<T>(vr[u][c], vf + c * kVec);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p[u], vf[e], acc[g][e]);
      }
    }
  }

  // merge the warp's row groups (lanes kTpr, 2·kTpr, ... apart hold the same dimensions)
#pragma unroll
  for (int off = kTpr; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lother = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float fa = rescale(m[g], mx), fb = rescale(mo, mx);
      l[g] = l[g] * fa + lother * fb;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * fa + ao * fb;
      }
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (sub == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) sm_acc[warp][g][(c * kTpr + sub) * kVec + j] = acc[g][c * kVec + j];
      }
    }
  }
  __syncthreads();

  // merge the warps; mx is -inf only in a split that holds no visible row
  // (past hi), which writes an empty partial; split 0 holds lo, so the
  // output is finite wherever some position is visible (NaN where none is)
  for (int i = threadIdx.x; i < a.g * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = rescale(sm_m[w][g], mx);
      sum += sm_l[w][g] * f;
      out += sm_acc[w][g][d] * f;
    }
    if (a.splits == 1) {
      store_out(a.out, (head * a.g + g) * HD + d, out / sum, a.q_bf16);
    } else {
      float* p = a.part + ((head * a.splits + split) * a.g + g) * (HD + 2);
      p[d] = out;
      if (d == 0) {
        p[HD] = mx;
        p[HD + 1] = sum;
      }
    }
  }
}

// One block a (row, KV head): merge the splits' partials into the output.
__global__ void __launch_bounds__(kCombineThreads) combine_kernel(const Args a, int hd) {
  const size_t head = blockIdx.x;
  for (int i = threadIdx.x; i < a.g * hd; i += kCombineThreads) {
    const int g = i / hd, d = i % hd;
    const float* p = a.part + (head * a.splits * a.g + g) * (hd + 2);
    const size_t step = static_cast<size_t>(a.g) * (hd + 2);  // floats between splits
    float mx = -INFINITY;
    for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, p[s * step + hd]);
    float sum = 0.f, out = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float f = rescale(p[s * step + hd], mx);  // 0 for an empty split
      sum += p[s * step + hd + 1] * f;
      out += p[s * step + d] * f;
    }
    store_out(a.out, (head * a.g + g) * hd + d, out / sum, a.q_bf16);
  }
}

template <typename T, int HD, int GM>
cudaError_t launch(const Args& a, int batch, cudaStream_t st) {
  decode_kernel<T, HD, GM><<<dim3(a.splits, a.hkv, batch), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const Args& a, int batch, cudaStream_t st) {
  if (a.g <= 1) return launch<T, HD, 1>(a, batch, st);
  if (a.g <= 2) return launch<T, HD, 2>(a, batch, st);
  if (a.g <= 4) return launch<T, HD, 4>(a, batch, st);
  return launch<T, HD, 8>(a, batch, st);
}

template <typename T>
cudaError_t launch_hd(const Args& a, int batch, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_g<T, 32>(a, batch, st);
    case 64: return launch_g<T, 64>(a, batch, st);
    case 128: return launch_g<T, 128>(a, batch, st);
    case 256: return launch_g<T, 256>(a, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* hk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, out (B, 1, Hkv, G, hd) contiguous, bfloat16 (q_bf16) or float32;
// k, v (B, smax, Hkv, hd) contiguous, 16-byte aligned, bfloat16 (kv_bf16)
// or float32; hd in {32, 64, 128, 256}, 1 <= g <= 8; pos (1,) int32 on the
// device, the token's position, read by every block; window 0 for none;
// `splits` chunks of `chunk` positions that cover the widest visible range
// (kernels/gqa_decode.py, `plan`); part (B, Hkv, splits, G, hd + 2)
// float32, unused when splits is 1; cap 0 for no softcap.
int hk_decode_attention(const void* q, const void* k, const void* v, void* out, float* part, const int* pos,
                        int q_bf16, int kv_bf16, int batch, int smax, int hkv, int g, int hd, int window,
                        int chunk, int splits, float scale, float cap, void* stream) {
  if (g < 1 || g > 8 || splits < 1 || batch < 1 || chunk < 1 || window < 0 || pos == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, out, part, pos, q_bf16, smax, hkv, g, window, chunk, splits, scale, cap};
  cudaError_t err = kv_bf16 ? launch_hd<__nv_bfloat16>(a, batch, hd, st) : launch_hd<float>(a, batch, hd, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  combine_kernel<<<batch * hkv, kCombineThreads, 0, st>>>(a, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Fused UNet1D residual block, float32, for sm_90a.
//
// Replaces diffsg_tpu/ops/pallas_kernels.py::fused_residual_block (kernel
// body _resblock_kernel). Per row of x it computes
//
//   h   = swish(LN1(x)) @ W1 + b1 + t_proj
//   h   = swish(LN2(h)) @ W2 + b2 + c_proj
//   h   = swish(LN3(h)) @ W3 + b3
//   out = h + (x @ Ws + bs  when a shortcut is given, else x)
//
// with LayerNorm eps 1e-5 and a two-pass variance, all in float32 (the JAX
// kernel is float32 only). Weights keep flax's (in, out) layout.
//
// Bound on an H100: float32 SIMT operations for the wide blocks (the tensor
// cores take float32 only as TF32, about three digits). 256 -> 128 with a
// shortcut at 16,384 rows is 3.2 GFLOP, 48 us at 67 TFLOP/s, against 34 MB
// moved, 10 us at 3.35 TB/s. Blocks no wider than 32 are bound by bytes and
// by the launch (0.5-2 us of bound each).
//
// Wide path (max(in, out) > 32; resblock_wide). One CTA of 256 threads per
// tile of TM = 32 or 64 rows; a grid sized by the caller walks the tiles.
// - All four products have N = out columns. A warp is 4 lanes down by 8
//   across, and each lane owns a TR x 4 or TR x 8 micro-tile of outputs
//   (rows 4 apart, float4 columns 32 apart), accumulated in registers.
//   Per 4 k-steps a lane loads TR float4s of activations (a warp reads 4
//   rows, padded by 4 floats onto other banks) and 4 or 8 float4s of
//   weights (128 contiguous bytes a warp): one shared-memory wavefront each,
//   12 for 128 FMAs at TR = 4, TC = 8.
// - Weights stream through a ring of three 16 KB slots in shared memory
//   with cp.async.cg 16-byte copies, one commit group per slot. The chunks
//   of Ws, W1, W2 and W3 form one stream per tile, so the next product's
//   first chunks land while the current one finishes and its epilogue
//   runs. Each chunk costs one __syncthreads, which also frees the slot
//   read before it.
// - One activation tile (TM x max(in, out)) holds each product's operand.
//   LayerNorm 1 runs in place on the x tile, one warp per row with the row
//   in registers. LayerNorm 2 and 3 run on the accumulators in registers:
//   two passes, each summed over the 8 lanes across with shuffles and over
//   the warps across through the rows' pad, behind one barrier; the result
//   is stored once, as the next product's operand.
//   The shortcut (x @ Ws + bs) is computed first and waits in `out`, which
//   each lane reads back only where it wrote it; an identity shortcut
//   re-reads x. So the CTA's shared memory is the tile and the 48 KB ring:
//   at most 115,712 B for the MSR-3c and proj-256 blocks, two CTAs an SM.
//
// Narrow path (max(in, out) <= 32; resblock_narrow). These blocks are bound
// by bytes and by the launch, so the path spends no block barrier per row:
// - each CTA copies the whole block's weights and vectors to shared memory
//   once (at most 32 -> 32, 12 KB) with cp.async, all in flight at once
//   beside its first rows' x, t_proj and c_proj, behind its only
//   __syncthreads, and walks row tiles of a grid sized by the caller;
// - G = 2, 4 or 8 lanes own a row (widths up to 8, 16, 32), one float4 of
//   each row vector a lane, so x, c_proj and out move in 16-byte accesses;
//   LayerNorm sums over the G lanes with sub-warp xor shuffles;
// - a product stages the row's activation in the warp's own shared memory
//   (__syncwarp only) and lane l computes output columns 4l..4l+3.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLnEps = 1e-5f;
constexpr int kSmemMax = 232448;        // dynamic shared memory a CTA may have on sm_90
constexpr int kSlotFloats = 4096;       // one ring slot: 16 KB of weights
constexpr int kSlots = 3;               // ring depth: two slots in flight while one is read
constexpr int kMaxWideIn = 512;         // LN1's warp holds a row as 4 float4 a lane
// The narrow path takes blocks no wider than this (8 lanes of one float4 a
// row); every wider block takes the wide path.
constexpr int kNarrowMaxWidth = 32;

enum Variant { kNarrow = 0, kWide = 1 };

struct ResblockArgs {
  const float* x;       // (rows, in)
  const float* t_proj;  // (1, out) with t_stride 0, or (rows, out) with t_stride out
  const float* c_proj;  // (rows, out)
  const float *g1, *be1, *w1, *b1;  // LN1 (in), W1 (in, out), b1 (out)
  const float *g2, *be2, *w2, *b2;  // LN2 (out), W2 (out, out)
  const float *g3, *be3, *w3, *b3;  // LN3 (out), W3 (out, out)
  const float *ws, *bs;             // shortcut (in, out), (out); null when in == out
  float* out;                       // (rows, out)
  int rows, in_dim, out_dim, t_stride;
};

// swish(v) = v * sigmoid(v) with the fast exponential and division (about
// 2 ulp each; __fdividef gives 0 once 1 + e^-v passes 2^126, where swish is
// -0 to float precision anyway).
__device__ __forceinline__ float swish(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// Sum over the G neighbouring lanes that share a row (G divides 32).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
// Four consecutive floats of a vector that need not be 16-byte aligned.
__device__ __forceinline__ float4 ldg4u(const float* p) {
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// 16-byte asynchronous copy global -> shared, bypassing L1 (.cg).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
// 4-byte asynchronous copy global -> shared (.ca: the only kind at 4 bytes).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Asks for the 128-byte line at p to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Wide path.

template <int TM, int NP>
struct WideShape {
  // A warp is 4 lanes down by 8 across; each lane owns kTR rows, 4 apart,
  // and kTC columns as kNV float4s, 32 apart.
  static constexpr int kTC = NP >= 128 ? 8 : 4;
  static constexpr int kNV = kTC / 4;
  static constexpr int kWN = 8 * kTC;                  // columns of a warp
  static constexpr int kWC = NP / kWN;                 // warps across
  static constexpr int kWR = kThreads / 32 / kWC;      // warps down
  static constexpr int kWM = TM / kWR;                 // rows of a warp
  static constexpr int kTR = kWM / 4;                  // rows of a lane
  static constexpr int kKC = kSlotFloats / NP;         // weight rows per ring slot
  // Floats past the widest row: a multiple of 4 (rows stay 16-byte aligned,
  // a warp's 4 rows fall on other banks) that holds 2 kWC LayerNorm sums.
  static constexpr int kPad = 2 * kWC > 4 ? 2 * kWC : 4;
  static_assert(kWC >= 1 && kWR * kWC == kThreads / 32 && kWM % 4 == 0 && kTR >= 1,
                "the warps must tile TM x NP");
};

// The weight matrices of one tile in the order they are multiplied: Ws (if
// any), W1, W2, W3, cut into ring chunks of KC rows.
struct WeightStream {
  const float* w[4];
  int k[4];
  int chunks[4];
  int total;
};

__device__ __forceinline__ void add_matrix(WeightStream& s, int& n, const float* w, int k,
                                           int kc) {
  s.w[n] = w;
  s.k[n] = k;
  s.chunks[n] = (k + kc - 1) / kc;
  s.total += s.chunks[n];
  ++n;
}

// Starts the copy of chunk q of the stream (nothing past its end) into
// ring slot q % kSlots. Row r of the chunk lands at slot + r * NP.
template <int NP, int KC>
__device__ __forceinline__ void issue_chunk(const WeightStream& s, int q, float* ring, int N) {
  if (q >= s.total) return;
  float* dst = ring + (q % kSlots) * kSlotFloats;
  int m = 0;
  while (q >= s.chunks[m]) q -= s.chunks[m++];
  const int k0 = q * KC, rows = min(KC, s.k[m] - k0);
  const float* src = s.w[m] + (size_t)k0 * N;
  const int n4 = N / 4;
  for (int idx = threadIdx.x; idx < rows * n4; idx += kThreads) {
    const int r = idx / n4, c = idx - r * n4;
    cp_async16(dst + r * NP + 4 * c, src + (size_t)r * N + 4 * c);
  }
}

// acc += act[:, 0:K] @ W for this lane's micro-tile (rows a + 4 i lda, columns
// w + 32 v), W streamed through the ring from chunk q on (q advances past
// W's chunks). One barrier per chunk: it makes the chunk (and anything
// written to shared memory before the call) visible to every thread, and
// frees the slot read in the previous chunk for the copy issued after it.
// Per 4 k-steps a lane loads kTR float4s of activations (4 rows a warp, on
// other banks by the rows' 4-float pad) and 4 kNV float4s of weights (128
// contiguous bytes a warp) for 16 kTR kNV FMAs.
template <int TM, int NP>
__device__ __forceinline__ void product(
    const float* a, int lda, int K, const WeightStream& s, int& q, float* ring, int N, int col0,
    float4 (&acc)[WideShape<TM, NP>::kTR][WideShape<TM, NP>::kNV]) {
  using S = WideShape<TM, NP>;
  constexpr int TR = S::kTR, NV = S::kNV, KC = S::kKC;
  for (int k0 = 0; k0 < K; k0 += KC, ++q) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();
    issue_chunk<NP, KC>(s, q + kSlots - 1, ring, N);
    cp_async_commit();
    const float* w = ring + (q % kSlots) * kSlotFloats + col0;
    const float* ak = a + k0;
    const int rows = min(KC, K - k0);
#pragma unroll 2
    for (int k = 0; k < rows; k += 4) {
      float4 wv[4][NV];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int v = 0; v < NV; ++v) wv[kk][v] = ld4(w + (k + kk) * NP + 32 * v);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 x = ld4(ak + 4 * i * lda + k);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float4& o = acc[i][v];
          o.x = fmaf(x.x, wv[0][v].x, o.x); o.y = fmaf(x.x, wv[0][v].y, o.y);
          o.z = fmaf(x.x, wv[0][v].z, o.z); o.w = fmaf(x.x, wv[0][v].w, o.w);
          o.x = fmaf(x.y, wv[1][v].x, o.x); o.y = fmaf(x.y, wv[1][v].y, o.y);
          o.z = fmaf(x.y, wv[1][v].z, o.z); o.w = fmaf(x.y, wv[1][v].w, o.w);
          o.x = fmaf(x.z, wv[2][v].x, o.x); o.y = fmaf(x.z, wv[2][v].y, o.y);
          o.z = fmaf(x.z, wv[2][v].z, o.z); o.w = fmaf(x.z, wv[2][v].w, o.w);
          o.x = fmaf(x.w, wv[3][v].x, o.x); o.y = fmaf(x.w, wv[3][v].y, o.y);
          o.z = fmaf(x.w, wv[3][v].z, o.z); o.w = fmaf(x.w, wv[3][v].w, o.w);
        }
      }
    }
  }
}

// a[r, 0:W] = swish(LN(a[r, 0:W]) * g + be) in place for the TM rows of the
// tile, one warp per row, the row held in registers (J float4 a lane, so
// W <= 128 J). A warp takes RB of its rows at once, so that their shuffle
// reductions interleave; g and be are read once per call.
template <int J, int RB>
__device__ __forceinline__ void ln_swish_rows(float* a, int lda, int W, int TM,
                                              const float* __restrict__ g,
                                              const float* __restrict__ be) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 gv[J], bv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = 4 * lane + 128 * j;
    gv[j] = c < W ? ldg4u(g + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    bv[j] = c < W ? ldg4u(be + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float inv_w = 1.0f / W;
  for (int r0 = warp * RB; r0 < TM; r0 += kThreads / 32 * RB) {
    float4 v[RB][J];
    float mean[RB], inv[RB];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 4 * lane + 128 * j;
        v[b][j] = c < W ? ld4(a + (r0 + b) * lda + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        s += (v[b][j].x + v[b][j].y) + (v[b][j].z + v[b][j].w);
      }
      mean[b] = s;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int b = 0; b < RB; ++b) mean[b] += __shfl_xor_sync(0xffffffffu, mean[b], o);
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      mean[b] *= inv_w;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (4 * lane + 128 * j >= W) continue;
        const float dx = v[b][j].x - mean[b], dy = v[b][j].y - mean[b];
        const float dz = v[b][j].z - mean[b], dw = v[b][j].w - mean[b];
        sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
      inv[b] = sq;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int b = 0; b < RB; ++b) inv[b] += __shfl_xor_sync(0xffffffffu, inv[b], o);
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const float rs = rsqrtf(inv[b] * inv_w + kLnEps);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 4 * lane + 128 * j;
        if (c >= W) continue;
        const float4 x = v[b][j];
        st4(a + (r0 + b) * lda + c,
            make_float4(swish((x.x - mean[b]) * rs * gv[j].x + bv[j].x),
                        swish((x.y - mean[b]) * rs * gv[j].y + bv[j].y),
                        swish((x.z - mean[b]) * rs * gv[j].z + bv[j].z),
                        swish((x.w - mean[b]) * rs * gv[j].w + bv[j].w)));
      }
    }
  }
}

// The injection of stage 1 or 2 (t_proj or c_proj) for this lane's
// micro-tile, zero on the rows past the ragged edge.
template <int TM, int NP>
__device__ __forceinline__ void load_rows(
    float4 (&dst)[WideShape<TM, NP>::kTR][WideShape<TM, NP>::kNV], const float* src,
    int stride, int row0, int r0, int nrows, int col0, const bool* ok) {
  using S = WideShape<TM, NP>;
#pragma unroll
  for (int i = 0; i < S::kTR; ++i)
#pragma unroll
    for (int v = 0; v < S::kNV; ++v) {
      const int r = r0 + 4 * i;
      dst[i][v] = ok[v] && r < nrows ? ldg4(src + (size_t)(row0 + r) * stride + col0 + 32 * v)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// A[:, 0:N] = swish(LN(h) * g + be) for h = acc + b + inj, held in this
// lane's micro-tile registers. The row statistics (two passes) sum over the
// 8 lanes across a warp with shuffles and over the kWC warps across the
// tile through 2 kWC floats of each row's pad in A (columns W..W + 2 kWC,
// past every column a product reads), behind a barrier each. The first
// barrier also lets every lane finish reading A in the product before the
// result overwrites it.
template <int TM, int NP>
__device__ __forceinline__ void ln_swish_regs(
    float4 (&h)[WideShape<TM, NP>::kTR][WideShape<TM, NP>::kNV],
    const float4 (&inj)[WideShape<TM, NP>::kTR][WideShape<TM, NP>::kNV], const float* bias,
    const float* g, const float* be, float* A, int lda, int W, int N, int r0, int col0,
    const bool* ok) {
  using S = WideShape<TM, NP>;
  constexpr int TR = S::kTR, NV = S::kNV, WC = S::kWC;
  const int lane = threadIdx.x & 31, wc = (threadIdx.x >> 5) % WC;
  float* red = A + r0 * lda + W;   // row r0 + 4 i: red[4 i lda + 0..2 WC)
  float mean[TR], rs[TR];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 b = ok[v] ? ldg4u(bias + col0 + 32 * v) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < TR; ++i) h[i][v] = add4(add4(h[i][v], b), inj[i][v]);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (ok[v]) s += (h[i][v].x + h[i][v].y) + (h[i][v].z + h[i][v].w);
    mean[i] = s;
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < TR; ++i) mean[i] += __shfl_xor_sync(0xffffffffu, mean[i], o);
  if ((lane & 7) == 0)
#pragma unroll
    for (int i = 0; i < TR; ++i) red[4 * i * lda + wc] = mean[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WC; ++w) s += red[4 * i * lda + w];
    mean[i] = s / N;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!ok[v]) continue;
      const float dx = h[i][v].x - mean[i], dy = h[i][v].y - mean[i];
      const float dz = h[i][v].z - mean[i], dw = h[i][v].w - mean[i];
      q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
    rs[i] = q;
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < TR; ++i) rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], o);
  if ((lane & 7) == 0)
#pragma unroll
    for (int i = 0; i < TR; ++i) red[4 * i * lda + WC + wc] = rs[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float q = 0.f;
#pragma unroll
    for (int w = 0; w < WC; ++w) q += red[4 * i * lda + WC + w];
    rs[i] = rsqrtf(q / N + kLnEps);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!ok[v]) continue;
    const int c = col0 + 32 * v;
    const float4 gv = ldg4u(g + c), bv = ldg4u(be + c);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float4 x = h[i][v];
      st4(A + (r0 + 4 * i) * lda + c,
          make_float4(swish((x.x - mean[i]) * rs[i] * gv.x + bv.x),
                      swish((x.y - mean[i]) * rs[i] * gv.y + bv.y),
                      swish((x.z - mean[i]) * rs[i] * gv.z + bv.z),
                      swish((x.w - mean[i]) * rs[i] * gv.w + bv.w)));
    }
  }
}

template <int TM, int NP>
__global__ void __launch_bounds__(kThreads, 2) resblock_wide(const ResblockArgs p) {
  using S = WideShape<TM, NP>;
  constexpr int TR = S::kTR, NV = S::kNV;
  extern __shared__ __align__(16) float smem[];
  const int in = p.in_dim, N = p.out_dim;
  const int W = max(in, N), lda = W + S::kPad;
  float* A = smem;                  // (TM, lda): x (LN1 in place), then LN2's, LN3's input
  float* ring = A + TM * lda;       // kSlots x kSlotFloats of weights
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / S::kWC) * S::kWM + (lane >> 3);        // this lane's rows: r0 + 4 i
  const int col0 = (warp % S::kWC) * S::kWN + 4 * (lane & 7);   // its columns: col0 + 32 v + 0..3
  const float* a = A + r0 * lda;

  WeightStream ws{};
  int n = 0;
  if (p.ws != nullptr) add_matrix(ws, n, p.ws, in, S::kKC);
  add_matrix(ws, n, p.w1, in, S::kKC);
  add_matrix(ws, n, p.w2, N, S::kKC);
  add_matrix(ws, n, p.w3, N, S::kKC);

  bool ok[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) ok[v] = col0 + 32 * v < N;

  const int ntiles = (p.rows + TM - 1) / TM;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * TM, nrows = min(TM, p.rows - row0);
    __syncthreads();  // the previous tile is done with A and the ring
    // x tile as the first commit group, zero past the ragged edge (LN of a
    // zero row stays finite); then the ring's first chunks.
    const int in4 = in / 4;
    for (int idx = threadIdx.x; idx < TM * in4; idx += kThreads) {
      const int r = idx / in4, c = idx - r * in4;
      if (r < nrows)
        cp_async16(A + r * lda + 4 * c, p.x + (size_t)row0 * in + 4 * idx);
      else
        st4(A + r * lda + 4 * c, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    cp_async_commit();
    int q = 0;
#pragma unroll
    for (int s = 0; s < kSlots - 1; ++s) {
      issue_chunk<NP, S::kKC>(ws, s, ring, N);
      cp_async_commit();
    }
    // The epilogues read c_proj (and a full t_proj) from L2, not DRAM.
    for (int i = threadIdx.x; i * 32 < nrows * N; i += kThreads) {
      prefetch_l2(p.c_proj + (size_t)row0 * N + 32 * i);
      if (p.t_stride) prefetch_l2(p.t_proj + (size_t)row0 * N + 32 * i);
    }
    cp_async_wait<kSlots - 1>();  // the x group; the ring's may still fly
    __syncthreads();

    float4 acc[TR][NV], inj[TR][NV];
    auto zero_acc = [&] {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[i][v] = make_float4(0.f, 0.f, 0.f, 0.f);
    };
    // The shortcut x @ Ws + bs first, parked in `out` (each lane reads back
    // only what it wrote, at the end).
    if (p.ws != nullptr) {
      zero_acc();
      product<TM, NP>(a, lda, in, ws, q, ring, N, col0, acc);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!ok[v]) continue;
        const int c = col0 + 32 * v;
        const float4 b = ldg4u(p.bs + c);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int r = r0 + 4 * i;
          if (r < nrows) st4(p.out + (size_t)(row0 + r) * N + c, add4(acc[i][v], b));
        }
      }
      __syncthreads();  // every read of the raw x tile is done
    }
    if (in <= 128)
      ln_swish_rows<1, 4>(A, lda, in, TM, p.g1, p.be1);
    else if (in <= 256)
      ln_swish_rows<2, 4>(A, lda, in, TM, p.g1, p.be1);
    else
      ln_swish_rows<kMaxWideIn / 128, 2>(A, lda, in, TM, p.g1, p.be1);

    // h1 = swish(LN1(x)) @ W1 + b1 + t_proj; swish(LN2(h1)) into A.
    zero_acc();
    product<TM, NP>(a, lda, in, ws, q, ring, N, col0, acc);
    load_rows<TM, NP>(inj, p.t_proj, p.t_stride, row0, r0, nrows, col0, ok);
    ln_swish_regs<TM, NP>(acc, inj, p.b1, p.g2, p.be2, A, lda, W, N, r0, col0, ok);

    // h2 = swish(LN2(h1)) @ W2 + b2 + c_proj; swish(LN3(h2)) into A.
    zero_acc();
    product<TM, NP>(a, lda, N, ws, q, ring, N, col0, acc);
    load_rows<TM, NP>(inj, p.c_proj, N, row0, r0, nrows, col0, ok);
    ln_swish_regs<TM, NP>(acc, inj, p.b2, p.g3, p.be3, A, lda, W, N, r0, col0, ok);

    // out = (swish(LN3(h2)) @ W3 + b3) + (x @ Ws + bs, or x).
    zero_acc();
    product<TM, NP>(a, lda, N, ws, q, ring, N, col0, acc);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!ok[v]) continue;
      const int c = col0 + 32 * v;
      const float4 b = ldg4u(p.b3 + c);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = r0 + 4 * i;
        if (r >= nrows) continue;
        float* o = p.out + (size_t)(row0 + r) * N + c;
        const float4 sc = p.ws != nullptr ? ld4(o) : ldg4(p.x + (size_t)(row0 + r) * in + c);
        st4(o, add4(add4(acc[i][v], b), sc));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Narrow path.

// swish(LN(v) * g + be) of a row held as one float4 a lane by G lanes (the
// lanes past the width hold zeros, add nothing and get zeros back).
template <int G>
__device__ __forceinline__ float4 ln_swish_row4(float4 v, int W, bool ok, const float* g,
                                                const float* be) {
  const float mean = group_sum<G>(ok ? (v.x + v.y) + (v.z + v.w) : 0.f) / W;
  const float dx = v.x - mean, dy = v.y - mean, dz = v.z - mean, dw = v.w - mean;
  const float sq = ok ? (dx * dx + dy * dy) + (dz * dz + dw * dw) : 0.f;
  const float inv = rsqrtf(group_sum<G>(sq) / W + kLnEps);
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 gv = ld4(g), bv = ld4(be);
  return make_float4(swish(dx * inv * gv.x + bv.x), swish(dy * inv * gv.y + bv.y),
                     swish(dz * inv * gv.z + bv.z), swish(dw * inv * gv.w + bv.w));
}

// a[0:K] @ W[:, c:c+4], a and W (K, N) in shared memory, K <= KMAX: the
// loop unrolls, so the shared loads of all k-steps can be in flight at once.
template <int KMAX>
__device__ __forceinline__ float4 row_dot4(const float* a, int K, const float* W, int N) {
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < KMAX; k += 4) {
    if (k >= K) break;
    const float4 x = ld4(a + k);
    const float4 w0 = ld4(W + (k + 0) * N), w1 = ld4(W + (k + 1) * N);
    const float4 w2 = ld4(W + (k + 2) * N), w3 = ld4(W + (k + 3) * N);
    o.x = fmaf(x.x, w0.x, o.x); o.y = fmaf(x.x, w0.y, o.y);
    o.z = fmaf(x.x, w0.z, o.z); o.w = fmaf(x.x, w0.w, o.w);
    o.x = fmaf(x.y, w1.x, o.x); o.y = fmaf(x.y, w1.y, o.y);
    o.z = fmaf(x.y, w1.z, o.z); o.w = fmaf(x.y, w1.w, o.w);
    o.x = fmaf(x.z, w2.x, o.x); o.y = fmaf(x.z, w2.y, o.y);
    o.z = fmaf(x.z, w2.z, o.z); o.w = fmaf(x.z, w2.w, o.w);
    o.x = fmaf(x.w, w3.x, o.x); o.y = fmaf(x.w, w3.y, o.y);
    o.z = fmaf(x.w, w3.z, o.z); o.w = fmaf(x.w, w3.w, o.w);
  }
  return o;
}

// Starts the copy of n floats to shared memory: 16-byte copies for a
// 16-byte aligned matrix (n a multiple of 4), 4-byte ones for a vector.
__device__ __forceinline__ void copy_to_shared(float* dst, const float* src, int n, bool vec4) {
  if (vec4) {
    for (int i = threadIdx.x; 4 * i < n; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i);
  }
}

// G lanes per row, one float4 of every row vector a lane (G = 2, 4, 8 for
// widths up to 8, 16, 32); 32 / G rows a warp, kThreads / G rows a CTA
// pass. The block's weights and vectors are copied to shared memory once
// per CTA, behind the only __syncthreads; after that each warp works alone.
// A product reads the row's activation, staged by its G lanes in the warp's
// own shared memory (two buffers, __syncwarp between), and the weights as
// float4 along n: lane l computes output columns 4l..4l+3.
template <int G>
__global__ void __launch_bounds__(kThreads) resblock_narrow(const ResblockArgs p) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kTileRows = kThreads / 32 * kRowsPerWarp;
  constexpr int kLd = 4 * G + 4;   // staging row stride: rows of a warp on other banks
  extern __shared__ __align__(16) float smem[];
  const int in = p.in_dim, N = p.out_dim;
  const bool dense_sc = p.ws != nullptr;
  float* w1 = smem;                          // (in, N)
  float* w2 = w1 + in * N;                   // (N, N)
  float* w3 = w2 + N * N;                    // (N, N)
  float* wsc = w3 + N * N;                   // (in, N) when the block has a shortcut
  float* g1 = wsc + (dense_sc ? in * N : 0);
  float* be1 = g1 + in;
  float* b1 = be1 + in;
  float *g2 = b1 + N, *be2 = g2 + N, *b2 = be2 + N;
  float *g3 = b2 + N, *be3 = g3 + N, *b3 = be3 + N, *bs = b3 + N;
  float* stage = bs + N;                     // per warp: 2 x (rows a warp, kLd)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane / G, c = 4 * (lane % G);
  const bool in_ok = c < in, out_ok = c < N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // This lane's x, t_proj and c_proj of a pass's row; the first pass's are
  // asked for before the weight copy, each next pass's before the store.
  float4 x, t, cp;
  auto load_inputs = [&](int r) {
    const bool live = r < p.rows;
    x = live && in_ok ? ldg4(p.x + (size_t)r * in + c) : zero;
    t = live && out_ok ? ldg4(p.t_proj + (size_t)r * p.t_stride + c) : zero;
    cp = live && out_ok ? ldg4(p.c_proj + (size_t)r * N + c) : zero;
  };
  const int row_in_tile = warp * kRowsPerWarp + gr;
  load_inputs(blockIdx.x * kTileRows + row_in_tile);

  // All of the block's weights at once, one commit group, one wait.
  copy_to_shared(w1, p.w1, in * N, true);
  copy_to_shared(w2, p.w2, N * N, true);
  copy_to_shared(w3, p.w3, N * N, true);
  if (dense_sc) {
    copy_to_shared(wsc, p.ws, in * N, true);
    copy_to_shared(bs, p.bs, N, false);
  }
  copy_to_shared(g1, p.g1, in, false);
  copy_to_shared(be1, p.be1, in, false);
  copy_to_shared(b1, p.b1, N, false);
  copy_to_shared(g2, p.g2, N, false);
  copy_to_shared(be2, p.be2, N, false);
  copy_to_shared(b2, p.b2, N, false);
  copy_to_shared(g3, p.g3, N, false);
  copy_to_shared(be3, p.be3, N, false);
  copy_to_shared(b3, p.b3, N, false);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float* s0 = stage + warp * 2 * kRowsPerWarp * kLd + gr * kLd;
  float* s1 = s0 + kRowsPerWarp * kLd;
  for (int row0 = blockIdx.x * kTileRows; row0 < p.rows; row0 += gridDim.x * kTileRows) {
    const int r = row0 + row_in_tile;
    float4 sc = x;
    if (dense_sc) {
      if (in_ok) st4(s0 + c, x);
      __syncwarp();
      sc = out_ok ? add4(row_dot4<4 * G>(s0, in, wsc + c, N), ld4(bs + c)) : zero;
    }
    float4 a = ln_swish_row4<G>(x, in, in_ok, g1 + c, be1 + c);
    if (in_ok) st4(s1 + c, a);
    __syncwarp();
    float4 h = out_ok ? add4(add4(row_dot4<4 * G>(s1, in, w1 + c, N), ld4(b1 + c)), t) : zero;
    a = ln_swish_row4<G>(h, N, out_ok, g2 + c, be2 + c);
    if (out_ok) st4(s0 + c, a);
    __syncwarp();
    h = out_ok ? add4(add4(row_dot4<4 * G>(s0, N, w2 + c, N), ld4(b2 + c)), cp) : zero;
    a = ln_swish_row4<G>(h, N, out_ok, g3 + c, be3 + c);
    if (out_ok) st4(s1 + c, a);
    __syncwarp();
    h = out_ok ? add4(add4(row_dot4<4 * G>(s1, N, w3 + c, N), ld4(b3 + c)), sc) : zero;
    load_inputs(r + gridDim.x * kTileRows);
    if (r < p.rows && out_ok) st4(p.out + (size_t)r * N + c, h);
    __syncwarp();  // the next row's staging overwrites what this one read
  }
}

// ---------------------------------------------------------------------------
// Host side: sizing (mirrored by ops/resblock.py) and launch.

struct LaunchInfo {
  int variant, tile_rows, grid, smem_bytes;
};
LaunchInfo g_last{};

// Output width the wide kernel is built for: the smallest of 32, 64, 128,
// 256 that holds out_dim (0: none).
int wide_np(int out_dim) {
  for (int np : {32, 64, 128, 256})
    if (out_dim <= np) return np;
  return 0;
}

int wide_smem_bytes(int tile_rows, int np, int in_dim, int out_dim) {
  const int wide = in_dim > out_dim ? in_dim : out_dim;
  const int pad = np > 128 ? 8 : 4;   // WideShape::kPad
  return (int)sizeof(float) * (tile_rows * (wide + pad) + kSlots * kSlotFloats);
}

// Lanes per row of the narrow path: one float4 of the widest row a lane
// (the row at most kNarrowMaxWidth wide).
int narrow_group(int in_dim, int out_dim) {
  const int wide = in_dim > out_dim ? in_dim : out_dim;
  return wide <= 8 ? 2 : wide <= 16 ? 4 : 8;
}

int narrow_smem_bytes(int in_dim, int out_dim, bool shortcut) {
  const int g = narrow_group(in_dim, out_dim);
  const int weights = in_dim * out_dim * (shortcut ? 2 : 1) + 2 * out_dim * out_dim;
  const int vectors = 2 * in_dim + 8 * out_dim;
  const int stage = (kThreads / 32) * 2 * (32 / g) * (4 * g + 4);
  return (int)sizeof(float) * (weights + vectors + stage);
}

using KernelFn = void (*)(ResblockArgs);

template <KernelFn kernel>
cudaError_t launch(int variant, int tile_rows, int grid, int smem, const ResblockArgs& p,
                   cudaStream_t stream) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  // The opt-in above 48 KB is per kernel; raise it to the largest size seen.
  static int smem_opt_in = 48 * 1024;
  if (smem > smem_opt_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_opt_in = smem;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  g_last = LaunchInfo{variant, tile_rows, grid, smem};
  return cudaGetLastError();
}

template <int TM, int NP>
cudaError_t launch_wide(const ResblockArgs& p, int grid, cudaStream_t s) {
  return launch<resblock_wide<TM, NP>>(kWide, TM, grid,
                wide_smem_bytes(TM, NP, p.in_dim, p.out_dim), p, s);
}

template <int G>
cudaError_t launch_narrow(const ResblockArgs& p, int grid, cudaStream_t s) {
  return launch<resblock_narrow<G>>(kNarrow, kThreads / G, grid,
                                    narrow_smem_bytes(p.in_dim, p.out_dim, p.ws != nullptr),
                                    p, s);
}

cudaError_t dispatch(const ResblockArgs& p, int tile_rows, int grid, cudaStream_t s) {
  const int in = p.in_dim, out = p.out_dim;
  if (grid < 1) return cudaErrorInvalidValue;
  if ((in > out ? in : out) <= kNarrowMaxWidth) {
    const int g = narrow_group(in, out);
    if (tile_rows != kThreads / g) return cudaErrorInvalidValue;
    if (g == 2) return launch_narrow<2>(p, grid, s);
    if (g == 4) return launch_narrow<4>(p, grid, s);
    return launch_narrow<8>(p, grid, s);
  }
  if (in > kMaxWideIn) return cudaErrorInvalidValue;
  switch (wide_np(out) * 1000 + tile_rows) {
    case 32032: return launch_wide<32, 32>(p, grid, s);
    case 32064: return launch_wide<64, 32>(p, grid, s);
    case 64032: return launch_wide<32, 64>(p, grid, s);
    case 64064: return launch_wide<64, 64>(p, grid, s);
    case 128032: return launch_wide<32, 128>(p, grid, s);
    case 128064: return launch_wide<64, 128>(p, grid, s);
    case 256032: return launch_wide<32, 256>(p, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the fused block on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a tile height the path is not built for, or a
// footprint over the 227 KB a CTA may have). The caller guarantees: float32,
// contiguous, in_dim and out_dim multiples of 4, x, t_proj, c_proj and the
// weight matrices 16-byte aligned, ws/bs both null exactly when
// in_dim == out_dim. tile_rows and grid are the caller's choice
// (ops/resblock.py: resblock_tile_rows, resblock_grid): the wide path takes
// 32- or 64-row tiles, the narrow path 256 / G rows (32, 64 or 128 at G = 8,
// 4, 2 lanes a row) and refuses any other height; on both paths the grid's
// CTAs walk the row tiles, gridDim.x tiles apart.
extern "C" int diffsg_resblock_f32(
    const float* x, const float* t_proj, int t_stride, const float* c_proj,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* g2, const float* be2, const float* w2, const float* b2,
    const float* g3, const float* be3, const float* w3, const float* b3,
    const float* ws, const float* bs, float* out,
    int rows, int in_dim, int out_dim, void* stream, int tile_rows, int grid) {
  const ResblockArgs p{x, t_proj, c_proj, g1, be1, w1, b1, g2, be2, w2, b2,
                       g3, be3, w3, b3, ws, bs, out, rows, in_dim, out_dim, t_stride};
  return dispatch(p, tile_rows, grid, static_cast<cudaStream_t>(stream));
}

// The variant (0 narrow, 1 wide), tile rows, grid and dynamic shared memory
// of the last launch in this process (all 0 before the first).
extern "C" void diffsg_resblock_last_launch(int* info) {
  info[0] = g_last.variant;
  info[1] = g_last.tile_rows;
  info[2] = g_last.grid;
  info[3] = g_last.smem_bytes;
}

extern "C" const char* diffsg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Whole-UNet1D forward in one launch, float32 or bfloat16, for sm_90a: the
// tile design (mega_kernel, this file) for every net in bfloat16 and for the
// wide nets in float32; the row-resident design (mega_kernel_rows and
// mega_kernel_rows_warp, mega_rows.cu) for the narrow float32 nets.
// ops/mega.py::mega_path picks one from the packed net and its type alone:
// float32, every layer input at most 64 wide and every output at most 32
// (the NU family: ckpts/ddpm_nu_3u_aug32_s8c, 8 to 64 wide) take the rows.
//
// What bounds each. The tile design runs every stage of every layer as a
// CTA-wide pass over a tile of rows in shared memory, with a __syncthreads()
// after each: about nine a residual block. On the wide nets (MSR-3c at 256,
// CO at 128, proj 256) each pass carries enough products to fill the SM
// between barriers. On the NU net's 8- to 32-wide layers it does not: a
// layer's ~68,000 FMAs a 32-row tile take ~0.5 us of issue, while the chain
// of passes, barriers, warp-wide LayerNorms on rows of 8 and weight loads
// from L2 takes ~17 us, so the kernel ran at ~3% of its bound (63.06 ms
// against 1.991 at 1,048,576 rows). The row-resident design keeps each row
// in one thread (or, for few rows, one warp) from the first layer to the
// last, stages each layer's weights once a CTA in shared memory and spends
// one barrier a layer; it is bound by issue, ~125,000 instructions a row.
//
// Replaces diffsg_tpu/ops/pallas_mega.py::unet_forward_mega (kernel body
// _kernel_body). For every row it runs the whole denoiser: feature_proj; the
// down blocks and resamples, pushing the skip stack; middle.res1 and res2;
// the up blocks, each concatenating [x, skip] before norm1; the final
// LN -> swish -> Linear. Each residual block computes
//
//   h   = dense(lin1, swish(LN1(x))) + dense(time_emb, st)
//   h   = dense(lin2, swish(LN2(h))) + dense(cond_emb, sc)
//   h   = dense(lin3, swish(LN3(h)))
//   out = h + (dense(shortcut, x) when in != out, else x)
//
// st = swish(time MLP(t)) (1, 4 * proj) and sc = swish(cond * mask) (rows, C)
// come in from the wrapper, as in the TPU kernel. In bfloat16 (T =
// __nv_bfloat16) the rounding points are the TPU kernel's: LN statistics,
// swish and each product's accumulation and bias add are float32 and the
// result is rounded to bf16; the residual adds round to bf16; the output is
// written as float32. In float32 every rounding is the identity. LN eps is
// 1e-5 with a two-pass variance.
//
// Bound on an H100: operations. The MSR-3c net (1.21M parameters outside
// the time MLP) does 550,456 multiply-adds per row, 18.0 GFLOP at 2B =
// 16,384 rows: 0.27 ms at the 67 TFLOP/s float32 SIMT peak, 18 us at the
// 989 TFLOP/s dense bf16 tensor-core peak. The NU net does 63,600 per row,
// 133 GFLOP at 1,048,576 rows (2.0 ms f32, 0.13 ms bf16); the proj-256 net
// of ckpts/ddpm_msr_80c_budget 4,229,280 per row (2.07 ms f32, 0.14 ms bf16
// at 16,384 rows). Activations move 36-660 bytes per row, so bytes never
// bound it.
//
// What this design does about that bound. bf16 products with K >= 16 and
// N >= 16 run on the tensor cores (nvcuda::wmma 16x16x16, float
// accumulators, mma.sync underneath): each warp owns strips of 16 output
// columns over the tile's rows, loads each weight fragment from L2 once per
// k-step and reuses it for up to four 16-row fragments, with four k-steps'
// weight loads in flight; each 16-deep product is added to the float32 sum
// by plain adds. bf16 tiles are 32, 64 or 128 rows, so each weight
// read from L2 serves R rows: MSR-3c at 16,384 rows reads its 2.5 MB of
// bf16 weights 256 times (64-row tiles), 0.65 GB, where 32-row tiles read
// them 512 times. float32 keeps SIMT FMAs (tensor cores in float32 would
// be TF32, about three decimal digits, against the 1e-4 the port holds
// float32 to) with 16- or 32-row tiles. The narrow products (K or N under
// 16: feature_proj and the head on the narrow nets, every product of an
// 8-wide block) and the condition projection inside lin2's epilogue stay
// SIMT in both types. Left undone: wgmma, TMA staging of the weights in
// shared memory, software pipelining across layers, warp specialisation,
// and float32 on the tensor cores.
//
// Design. A persistent grid: each CTA of 256 threads walks tiles of R rows
// and keeps the tile in dynamic shared memory: the y and sc tiles, the
// current x (wide enough for the concat), the activated tile
// a = swish(LN(.)), the block state h, and in bf16 one 16x16 float staging
// tile per warp for the tensor-core epilogue. The skip stack (744 values
// per row for MSR-3c, 2,208 for the proj-256 net) lives in device memory,
// one (R, skip_width) slice per CTA allocated by the wrapper: a CTA reads
// back only what it wrote, after a __syncthreads(), and the slices of one
// grid (a few tens of MB) stay in L2. Each block's time projection depends
// on st only, so a CTA computes all of them once (1,256 values for MSR-3c)
// before its first tile. The ragged last tile is zero-filled (LN of a
// constant row stays finite) and its stores are masked. The kernel walks a layer table built by
// ops/mega.py::pack_params (kind, widths, flags, skip offsets, the padded
// output width and the offsets of each weight in one packed buffer, each
// Dense padded to multiples of 16 with zeros and 32-byte aligned), so the
// net's shape is data. SIMT products: a thread owns one output column j
// for RPT rows of the tile, reads W[k * ldw + j] (neighbouring threads,
// neighbouring columns) and broadcasts four activations of a row from
// shared memory per four steps of k; RPT is picked per layer so that the
// column threads cover N. Every product ends in one Epilogue that adds the
// bias in float32, rounds to T and applies the layer's injection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;
constexpr int kTableCols = 32;
constexpr size_t kSmemMax = 232448;       // 227 KB per CTA

// Layer kinds, flags and table columns: ops/mega.py keeps the same numbers.
enum { FEATURE_PROJ = 0, BLOCK = 1, RESAMPLE = 2, HEAD = 3 };
enum { F_SHORTCUT = 1, F_PUSH = 2, F_CONCAT = 4 };
enum {
  K_KIND, K_IN, K_OUT, K_FLAGS, K_SKIP_OFF, K_SKIP_W, K_TPROJ,
  K_G1, K_BE1, K_W1, K_B1, K_WT, K_BT, K_G2, K_BE2, K_W2, K_B2, K_WC, K_BC,
  K_G3, K_BE3, K_W3, K_B3, K_WS, K_BS, K_LDW
};

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T fromf(float v);
template <> __device__ __forceinline__ float fromf<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// Round a float32 result to T and carry on in float32.
template <typename T> __device__ __forceinline__ float rnd(float v) { return tof(fromf<T>(v)); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride (in elements) of a shared-memory tile `w` values wide: a
// multiple of 4 in float32, so a row of four values is one aligned vector;
// in bf16 the width padded to 16, plus 8 so that rows start on other banks.
// ops/mega.py::_ld mirrors it.
template <typename T> int tile_ld(int w) {
  return std::is_same<T, float>::value ? round_up(w, 4) : round_up(w, 16) + 8;
}

struct Layout {
  int ldy, lds, ldx, ldh;   // y tile, sc tile, x / a tiles, h tile
  int time_pad, tproj_pad;  // st (T) and the time projections (float)
};

template <typename T>
struct MegaArgs {
  const T* y;        // (rows, D)
  const T* sc;       // (rows, C)
  const T* st;       // (time_dim,)
  const T* w;        // packed weights
  const int* table;  // (n_layers, kTableCols)
  float* out;        // (rows, D)
  T* skip;           // (grid, R, skip_w): each CTA's skip stack
  int rows, n_layers, D, C, time_dim, skip_w, n_tproj;
  Layout lay;
};

template <typename T> constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

// ops/mega.py::_smem_bytes mirrors this sizing.
template <typename T>
size_t smem_bytes(int R, const Layout& l) {
  const size_t stage = kBf16<T> ? sizeof(float) * kWarps * 256 : 0;
  return stage + sizeof(float) * l.tproj_pad +
         sizeof(T) * (l.time_pad + (size_t)R * (l.ldy + l.lds + 2 * l.ldx + l.ldh));
}

// What a product does with each finished sum acc = a[r, :] . W[:, j].
enum { M_STORE, M_LIN1, M_LIN2, M_ADD, M_RES, M_OUT };

template <typename T>
struct Epilogue {
  int mode;
  const T* bias;        // (N,)
  T* dst;               // tile written (or read and written) at [r * ldd + j]
  int ldd;
  const float* tproj;   // M_LIN1: this block's time projection (N,)
  const T* sc;          // M_LIN2: the sc tile, its stride, width C, W_c, b_c
  int lds, C;
  const T* wc;
  const T* bc;
  int N, ldw;           // true and padded output width
  float* gout;          // M_OUT: output rows of this tile, D wide
  int nrows;
  float* stage;         // bf16: kWarps staging tiles of 16 x 16 floats

  __device__ __forceinline__ void operator()(int r, int j, float acc) const {
    const float v = rnd<T>(acc + tof(__ldg(bias + j)));
    T* d = dst + r * ldd + j;
    switch (mode) {
      case M_STORE: *d = fromf<T>(v); break;
      case M_LIN1: *d = fromf<T>(v + tproj[j]); break;
      case M_LIN2: {
        float c = 0.f;
        for (int k = 0; k < C; ++k)
          c = fmaf(tof(sc[r * lds + k]), tof(__ldg(wc + (size_t)k * ldw + j)), c);
        *d = fromf<T>(v + rnd<T>(c + tof(__ldg(bc + j))));
        break;
      }
      case M_ADD: *d = fromf<T>(tof(*d) + v); break;   // h + shortcut(x)
      case M_RES: *d = fromf<T>(v + tof(*d)); break;   // h + x, in place in x
      default:
        if (r < nrows) gout[r * N + j] = v;
    }
  }
};

// epi(r, j, a[r, :K] . W[:K, j]) for every row of the tile and j < N; W's
// rows are ldw apart. RPT rows per thread: R / RPT row groups,
// 256 * RPT / R column threads.
template <typename T, int R, int RPT>
__device__ __forceinline__ void matmul_rpt(const T* a, int lda, int K,
                                           const T* __restrict__ W, int ldw, int N,
                                           const Epilogue<T>& epi) {
  constexpr int kGroups = R / RPT;
  constexpr int kCols = kThreads / kGroups;
  const int tcol = threadIdx.x % kCols, rg = threadIdx.x / kCols;
  const int K4 = K & ~3;
  for (int j = tcol; j < N; j += kCols) {
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int k = 0; k < K4; k += 4) {
      const float w0 = tof(__ldg(W + (size_t)(k + 0) * ldw + j));
      const float w1 = tof(__ldg(W + (size_t)(k + 1) * ldw + j));
      const float w2 = tof(__ldg(W + (size_t)(k + 2) * ldw + j));
      const float w3 = tof(__ldg(W + (size_t)(k + 3) * ldw + j));
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 v = load4(a + (rg + i * kGroups) * lda + k);
        acc[i] = fmaf(v.x, w0, acc[i]);
        acc[i] = fmaf(v.y, w1, acc[i]);
        acc[i] = fmaf(v.z, w2, acc[i]);
        acc[i] = fmaf(v.w, w3, acc[i]);
      }
    }
    for (int k = K4; k < K; ++k) {
      const float wk = tof(__ldg(W + (size_t)k * ldw + j));
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(tof(a[(rg + i * kGroups) * lda + k]), wk, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) epi(rg + i * kGroups, j, acc[i]);
  }
}

// The same on the tensor cores, bf16 in, float32 sums. A warp takes an item:
// a strip of 16 output columns j0.. and every G-th 16-row fragment of the
// tile from fragment g on (kFrags of them). It loads each k-step's 16x16
// weight fragment once, kUnroll k-steps ahead, and multiplies it into all
// kFrags row fragments of A, read from shared memory. The pad columns of A
// past K and the pad rows and columns of W are zero. Each finished 16x16
// sum goes through the warp's staging tile to epi, entry by entry.
template <int R, int G>
__device__ __forceinline__ void matmul_tc_g(const __nv_bfloat16* a, int lda, int K,
                                            const __nv_bfloat16* __restrict__ W, int ldw,
                                            int N, const Epilogue<__nv_bfloat16>& epi) {
  using namespace nvcuda;
  constexpr int kFrags = R / 16 / G, kUnroll = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strips = (N + 15) >> 4, ksteps = (K + 15) >> 4;
  float* stage = epi.stage + warp * 256;
  for (int item = warp; item < strips * G; item += kWarps) {
    const int j0 = (item / G) * 16, g = item % G;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFrags];
#pragma unroll
    for (int f = 0; f < kFrags; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int ks = 0; ks < ksteps; ks += kUnroll) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ks + u < ksteps) wmma::load_matrix_sync(b[u], W + (size_t)(ks + u) * 16 * ldw + j0, ldw);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ks + u >= ksteps) break;
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, a + (g + f * G) * 16 * lda + (ks + u) * 16, lda);
          // Each 16-deep sum starts from zero and joins the running sum by
          // float32 adds (round to nearest). Summed into acc on the tensor
          // cores instead, the proj-256 net's mean error against the plain
          // version was 8 times SIMT's, above bf16's own bound.
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> part;
          wmma::fill_fragment(part, 0.f);
          wmma::mma_sync(part, af, b[u], part);
#pragma unroll
          for (int i = 0; i < part.num_elements; ++i) acc[f].x[i] += part.x[i];
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
      wmma::store_matrix_sync(stage, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = (g + f * G) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int j = j0 + (e & 15);
        if (j < N) epi(r0 + (e >> 4), j, stage[e]);
      }
      __syncwarp();
    }
  }
}

// G, the row groups per strip: enough items for the warps where there are
// fewer strips than warps, and at least R / 64 so that a warp holds no more
// than four accumulator fragments.
template <int R, int G = 1>
__device__ __forceinline__ void matmul_tc(const __nv_bfloat16* a, int lda, int K,
                                          const __nv_bfloat16* __restrict__ W, int ldw, int N,
                                          const Epilogue<__nv_bfloat16>& epi) {
  if constexpr (G * 2 <= R / 16) {
    if (G * 64 < R || ((N + 15) >> 4) * G * 2 <= kWarps) {
      matmul_tc<R, G * 2>(a, lda, K, W, ldw, N, epi);
      return;
    }
  }
  matmul_tc_g<R, G>(a, lda, K, W, ldw, N, epi);
}

// bf16 products with K, N >= 16 go to the tensor cores, which read A up to
// K rounded to 16: where K is no multiple of 16 the pad columns are zeroed
// first (a stale NaN times a zero weight would be NaN). Else the smallest
// RPT whose column threads cover N, up to 16 rows per thread (more
// accumulators would spill under the 128-register cap of two CTAs per SM);
// wider outputs loop over column passes. Called by the whole CTA.
template <typename T, int R, int RPT = 1>
__device__ __forceinline__ void matmul(T* a, int lda, int K, const T* __restrict__ W,
                                       int ldw, int N, const Epilogue<T>& epi) {
  if constexpr (kBf16<T> && RPT == 1) {
    if (K >= 16 && N >= 16) {
      if (const int pad = round_up(K, 16) - K) {
        for (int i = threadIdx.x; i < R * pad; i += kThreads)
          a[(i / pad) * lda + K + i % pad] = fromf<T>(0.f);
        __syncthreads();
      }
      matmul_tc<R>(a, lda, K, W, ldw, N, epi);
      return;
    }
  }
  if constexpr (RPT < R && RPT < 16) {
    if (N > kThreads * RPT / R) {
      matmul<T, R, RPT * 2>(a, lda, K, W, ldw, N, epi);
      return;
    }
  }
  matmul_rpt<T, R, RPT>(a, lda, K, W, ldw, N, epi);
}

// dst[r, :width] = swish(LN(src[r, :width]) * g + be), one warp per row;
// lanes past the width add zero, which masks widths under 32.
template <typename T, int R>
__device__ void ln_swish(const T* src, int lds, int width, const T* __restrict__ g,
                         const T* __restrict__ be, T* dst, int ldd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kThreads / 32) {
    const T* s = src + r * lds;
    float sum = 0.f;
    for (int k = lane; k < width; k += 32) sum += tof(s[k]);
    const float mean = warp_sum(sum) / width;
    float sq = 0.f;
    for (int k = lane; k < width; k += 32) {
      const float d = tof(s[k]) - mean;
      sq += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(sq) / width + kLnEps);
    T* d = dst + r * ldd;
    for (int k = lane; k < width; k += 32) {
      const float v = rnd<T>((tof(s[k]) - mean) * inv * tof(__ldg(g + k)) + tof(__ldg(be + k)));
      d[k] = fromf<T>(swish(v));
    }

  }
}

template <typename T, int R>
__device__ void copy_cols(const T* src, int lds, T* dst, int ldd, int width) {
  for (int i = threadIdx.x; i < R * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[r * ldd + c] = src[r * lds + c];
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 2) mega_kernel(const MegaArgs<T> p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout& l = p.lay;
  float* stage = reinterpret_cast<float*>(smem_raw);   // bf16: per-warp 16x16 staging
  float* tproj = stage + (kBf16<T> ? kWarps * 256 : 0);  // every block's st @ W_t + b_t
  T* st = reinterpret_cast<T*>(tproj + l.tproj_pad);
  T* ys = st + l.time_pad;                 // (R, ldy) y tile
  T* scs = ys + R * l.ldy;                 // (R, lds) sc tile
  T* xs = scs + R * l.lds;                 // (R, ldx) x, and [x, skip] for up blocks
  T* as = xs + R * l.ldx;                  // (R, ldx) swish(LN(.))
  T* hs = as + R * l.ldx;                  // (R, ldh) block state
  // This CTA's skip stack in device memory; the entry at (off, w) is (R, w).
  // A CTA reads back only what it wrote, after a __syncthreads().
  T* skip = p.skip + (size_t)blockIdx.x * R * p.skip_w;
  const T* __restrict__ W = p.w;
  const int tid = threadIdx.x;

  for (int i = tid; i < p.time_dim; i += kThreads) st[i] = p.st[i];
  __syncthreads();
  for (int f = tid; f < p.n_tproj; f += kThreads) {
    const int* L = p.table;
    for (int li = 0; li < p.n_layers; ++li, L += kTableCols) {
      const int off = __ldg(L + K_TPROJ);
      if (__ldg(L + K_KIND) == BLOCK && f >= off && f < off + __ldg(L + K_OUT)) break;
    }
    const int ldw = __ldg(L + K_LDW), j = f - __ldg(L + K_TPROJ);
    const T* wt = W + __ldg(L + K_WT) + j;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < p.time_dim; ++k)
      acc = fmaf(tof(st[k]), tof(__ldg(wt + (size_t)k * ldw)), acc);
    tproj[f] = rnd<T>(acc + tof(__ldg(W + __ldg(L + K_BT) + j)));
  }

  const T zero = fromf<T>(0.f);
  const int ntiles = (p.rows + R - 1) / R;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * R;
    const int nrows = min(R, p.rows - row0);
    __syncthreads();   // the last tile's readers are done with ys and scs
    for (int i = tid; i < R * l.ldy; i += kThreads) {
      const int r = i / l.ldy, c = i - r * l.ldy;
      ys[i] = (r < nrows && c < p.D) ? p.y[(size_t)(row0 + r) * p.D + c] : zero;
    }
    for (int i = tid; i < R * l.lds; i += kThreads) {
      const int r = i / l.lds, c = i - r * l.lds;
      scs[i] = (r < nrows && c < p.C) ? p.sc[(size_t)(row0 + r) * p.C + c] : zero;
    }
    __syncthreads();

    int cur = 0;   // width of x in xs
    const int* L = p.table;
    for (int li = 0; li < p.n_layers; ++li, L += kTableCols) {
      const int kind = __ldg(L + K_KIND), in = __ldg(L + K_IN), out = __ldg(L + K_OUT);
      const int flags = __ldg(L + K_FLAGS), ldw = __ldg(L + K_LDW);
      Epilogue<T> e{};
      e.mode = M_STORE;
      e.bias = W + __ldg(L + K_B1);
      e.N = out, e.ldw = ldw, e.stage = stage;
      if (kind == FEATURE_PROJ) {
        e.dst = xs, e.ldd = l.ldx;
        matmul<T, R>(ys, l.ldy, in, W + __ldg(L + K_W1), ldw, out, e);
        __syncthreads();
      } else if (kind == RESAMPLE) {
        e.dst = hs, e.ldd = l.ldh;
        matmul<T, R>(xs, l.ldx, in, W + __ldg(L + K_W1), ldw, out, e);
        __syncthreads();
        copy_cols<T, R>(hs, l.ldh, xs, l.ldx, out);
        __syncthreads();
      } else if (kind == BLOCK) {
        if (flags & F_CONCAT) {
          const int sw = __ldg(L + K_SKIP_W);
          copy_cols<T, R>(skip + R * __ldg(L + K_SKIP_OFF), sw, xs + cur, l.ldx, sw);
          __syncthreads();
        }
        ln_swish<T, R>(xs, l.ldx, in, W + __ldg(L + K_G1), W + __ldg(L + K_BE1), as, l.ldx);
        __syncthreads();
        e.mode = M_LIN1, e.dst = hs, e.ldd = l.ldh, e.tproj = tproj + __ldg(L + K_TPROJ);
        matmul<T, R>(as, l.ldx, in, W + __ldg(L + K_W1), ldw, out, e);
        __syncthreads();
        ln_swish<T, R>(hs, l.ldh, out, W + __ldg(L + K_G2), W + __ldg(L + K_BE2), as, l.ldx);
        __syncthreads();
        e.mode = M_LIN2, e.bias = W + __ldg(L + K_B2);
        e.sc = scs, e.lds = l.lds, e.C = p.C;
        e.wc = W + __ldg(L + K_WC), e.bc = W + __ldg(L + K_BC);
        matmul<T, R>(as, l.ldx, out, W + __ldg(L + K_W2), ldw, out, e);
        __syncthreads();
        ln_swish<T, R>(hs, l.ldh, out, W + __ldg(L + K_G3), W + __ldg(L + K_BE3), as, l.ldx);
        __syncthreads();
        e.bias = W + __ldg(L + K_B3);
        if (flags & F_SHORTCUT) {
          e.mode = M_STORE;
          matmul<T, R>(as, l.ldx, out, W + __ldg(L + K_W3), ldw, out, e);
          __syncthreads();
          e.mode = M_ADD, e.bias = W + __ldg(L + K_BS);
          matmul<T, R>(xs, l.ldx, in, W + __ldg(L + K_WS), ldw, out, e);
          __syncthreads();
          copy_cols<T, R>(hs, l.ldh, xs, l.ldx, out);
        } else {
          // in == out: each thread adds x[r, j] of the (r, j) it owns.
          e.mode = M_RES, e.dst = xs, e.ldd = l.ldx;
          matmul<T, R>(as, l.ldx, out, W + __ldg(L + K_W3), ldw, out, e);
        }
        __syncthreads();
      } else {   // HEAD
        ln_swish<T, R>(xs, l.ldx, in, W + __ldg(L + K_G1), W + __ldg(L + K_BE1), as, l.ldx);
        __syncthreads();
        e.mode = M_OUT, e.dst = hs, e.ldd = 0;
        e.gout = p.out + (size_t)row0 * out, e.nrows = nrows;
        matmul<T, R>(as, l.ldx, in, W + __ldg(L + K_W1), ldw, out, e);
      }
      if (flags & F_PUSH) {
        copy_cols<T, R>(xs, l.ldx, skip + R * __ldg(L + K_SKIP_OFF), out, out);
        __syncthreads();
      }
      cur = out;
    }
  }
}

int g_last_launch[3] = {0, 0, 0};   // tile rows, grid, shared-memory bytes

template <typename T, int R>
cudaError_t launch(const MegaArgs<T>& p, int grid, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(R, p.lay);
  if (smem > kSmemMax || grid < 1) return cudaErrorInvalidValue;
  // The opt-in above 48 KB is per instantiation; raise it once to the largest size seen.
  static size_t smem_opt_in = 48 * 1024;
  if (smem > smem_opt_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_opt_in = smem;
  }
  g_last_launch[0] = R, g_last_launch[1] = grid, g_last_launch[2] = (int)smem;
  mega_kernel<T, R><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int run(const void* y, const void* sc, const void* st, const void* w, const int* table,
        float* out, void* skip, int rows, int n_layers, int D, int C, int time_dim,
        int skip_w, int max_in, int max_out, int n_tproj, int tile_rows, int grid,
        cudaStream_t stream) {
  const Layout lay{tile_ld<T>(D), tile_ld<T>(C), tile_ld<T>(max_in > max_out ? max_in : max_out),
                   tile_ld<T>(max_out), round_up(time_dim, 16), round_up(n_tproj, 8)};
  const MegaArgs<T> p{static_cast<const T*>(y), static_cast<const T*>(sc),
                      static_cast<const T*>(st), static_cast<const T*>(w), table, out,
                      static_cast<T*>(skip), rows, n_layers, D, C, time_dim, skip_w, n_tproj,
                      lay};
  if constexpr (kBf16<T>) {
    if (tile_rows == 32) return launch<T, 32>(p, grid, stream);
    if (tile_rows == 64) return launch<T, 64>(p, grid, stream);
    if (tile_rows == 128) return launch<T, 128>(p, grid, stream);
  } else {
    if (tile_rows == 16) return launch<T, 16>(p, grid, stream);
    if (tile_rows == 32) return launch<T, 32>(p, grid, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches the whole forward on `stream` over `grid` CTAs of `tile_rows`
// rows; returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// tile height the type is not built for, or whose shared memory exceeds a
// CTA's). dtype 0 is float32, 1 bfloat16 (y, sc, st, the weights and the
// skip scratch are of that type; out is float32). The caller guarantees
// contiguous arrays, a table and weights from ops/mega.py::pack_params
// (each Dense padded to 16 x 16 multiples, each array 32-byte aligned),
// every width a multiple of 4, and grid * tile_rows * skip_w values of
// skip scratch.
extern "C" int diffsg_unet_mega(const void* y, const void* sc, const void* st, const void* w,
                                const int* table, float* out, void* skip, int dtype, int rows,
                                int n_layers, int D, int C, int time_dim, int skip_w,
                                int max_in, int max_out, int n_tproj, int tile_rows, int grid,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(y, sc, st, w, table, out, skip, rows, n_layers, D, C, time_dim, skip_w,
                      max_in, max_out, n_tproj, tile_rows, grid, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(y, sc, st, w, table, out, skip, rows, n_layers, D, C, time_dim,
                              skip_w, max_in, max_out, n_tproj, tile_rows, grid, s);
  return cudaErrorInvalidValue;
}

// The tile rows, grid size and shared-memory bytes of the last launch.
extern "C" void diffsg_unet_mega_last_launch(int* info) {
  for (int i = 0; i < 3; ++i) info[i] = g_last_launch[i];
}

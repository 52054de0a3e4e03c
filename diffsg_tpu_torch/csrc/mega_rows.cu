// Whole-UNet1D forward in one launch for the narrow float32 nets: the
// row-resident design of the mega kernel (mega_kernel_rows, and
// mega_kernel_rows_warp for few rows), for sm_90a. mega.cu's note says which
// nets take it and why.
//
// It computes what mega.cu's float32 path computes (diffsg_tpu/ops/
// pallas_mega.py::unet_forward_mega): feature_proj; the down blocks and
// resamples, pushing the skip stack; middle.res1 and res2; the up blocks on
// [x, skip]; LN -> swish -> the head. Every Dense is summed with fmaf over k
// in ascending order from zero and its bias added after, as mega.cu's
// matmul_rpt does, so a Dense gives the same bits on the same inputs.
// LayerNorm (eps 1e-5, two-pass variance) sums a row in sequence with a
// thread a row, which moves its statistics by ulps, and by mega.cu's warp
// tree with a warp a row, which gives mega.cu's bits. Float32 SIMT FMAs
// throughout; expf and an IEEE division in swish.
//
// Both layouts keep a row resident from the first layer to the last:
// - Each layer's arrays (all a block reads per row but W_t and b_t, which
//   pack_params puts before them) are one contiguous range of the packed
//   buffer (table columns K_STAGE, K_NSTAGE). One thread copies the range
//   into one of nbuf shared-memory buffers with a bulk asynchronous copy
//   (cp.async.bulk, completing on an mbarrier), nbuf - 1 layers ahead of the
//   compute, so the next layers' weights land while this one computes. The
//   only CTA barrier is the one after each layer that retires its buffer:
//   one a layer, where mega.cu's tile design spends about nine. A product
//   reads W's row k from shared memory as the same address across the warp.
// - The layer table is copied into shared memory, and every block's time
//   projection st @ W_t + b_t, which depends on st alone, is computed once a
//   CTA before its first tile, as mega.cu does.
// - Rows past the end of the last tile compute nothing that is stored.
//
// A thread a row (mega_kernel_rows; many rows). LayerNorm, the activation,
// the residual add, the shortcut, the time projection add and the condition
// projection are thread-local: no shuffle and no barrier.
// - The row's data lives in the thread's own columns of shared memory: x
//   (as wide as the widest concat), the stashed block state h and the
//   activated condition sc, column c of the CTA's rows at [c * rows + r], so
//   a warp's 32 rows of one column are 32 consecutive banks. A product
//   y[j] = sum_k a(x[k]) * W[k, j] keeps its out <= 32 sums in registers
//   (template N, the layer's width class 8, 16 or 32) and loops over k at
//   run time: one load of x[k] and N / 4 broadcast float4 loads of W's row
//   k, each serving 4 FMAs. The activations swish(LN(x)) are computed as the
//   product consumes them, kGroup at a time. Unrolling k too would put the
//   products' whole arithmetic in straight-line code (~170 KB for one
//   64 -> 32 block), past the instruction caches.
// - The skip stack stays in device memory, one (skip_w, rows) slice a CTA,
//   column-major: a warp's 32 rows of one column are 128 contiguous bytes.
// - Two weight buffers: the rows' columns take the rest of shared memory.
//
// A warp a row (mega_kernel_rows_warp; up to ROW_WARP_MAX_ROWS rows in
// ops/mega.py). With few rows a thread a row leaves most of the card idle
// behind one thread's chain of a whole forward (~125,000 instructions). A
// row's vector of up to 64 values lies across a warp's registers (value c in
// lane c % 32, slot c / 32), lane j computes output column j, each lane
// computes the activations of its own values and shuffles broadcast them to
// the product, and LayerNorm sums over the warp. Four weight buffers; the
// skip stack is each row's contiguous slice in device memory.
//
// Limits, which ops/mega.py::ROW_MAX_IN and ROW_MAX_OUT repeat: every output
// (the head's D included) at most kMaxOut = 32 wide, since a thread-a-row
// block keeps two sets of N sums live (h with the condition's or the
// shortcut's sum) beside a row of W in registers, 64 + 32 of a thread's
// registers at N = 32, under the cap of 168 that kMaxRows threads a CTA
// leave; every input at most kMaxIn = 64, since x's columns are the largest
// part of a row's shared memory (64 + 32 + C columns a row: 384 rows, two
// weight buffers and the table in 227 KB for the NU net), and a warp holds
// two values a lane.
//
// Bound on an H100: operations, as for mega.cu: the NU net's 63,600
// multiply-adds a row are 133 GFLOP at 1,048,576 rows, 2.0 ms at the 67
// TFLOP/s float32 peak. With a thread a row, issue is the nearer limit: with
// the loads of x and W, LayerNorm and swish (expf, division), a row costs
// ~125,000 instructions of its warp, a warp's instruction serving 32 rows.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxRows = 384;            // rows (threads) a CTA at most, a thread a row
constexpr int kMaxWarpRows = 16;         // rows (warps) a CTA at most, a warp a row
constexpr int kMaxIn = 64;
constexpr int kMaxOut = 32;
constexpr int kTableCols = 32;
constexpr float kLnEps = 1e-5f;
constexpr size_t kSmemMax = 232448;      // 227 KB per CTA
constexpr int kHead = 128;               // bytes before the weight buffers: the mbarriers
constexpr int kMaxBuffers = 4;           // weight buffers, one mbarrier each

// Layer kinds, flags and table columns: ops/mega.py keeps the same numbers.
enum { FEATURE_PROJ = 0, BLOCK = 1, RESAMPLE = 2, HEAD = 3 };
enum { F_SHORTCUT = 1, F_PUSH = 2, F_CONCAT = 4 };
enum {
  K_KIND, K_IN, K_OUT, K_FLAGS, K_SKIP_OFF, K_SKIP_W, K_TPROJ,
  K_G1, K_BE1, K_W1, K_B1, K_WT, K_BT, K_G2, K_BE2, K_W2, K_B2, K_WC, K_BC,
  K_G3, K_BE3, K_W3, K_B3, K_WS, K_BS, K_LDW, K_STAGE, K_NSTAGE
};

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct RowArgs {
  const float* y;      // (rows, D)
  const float* sc;     // (rows, C)
  const float* st;     // (time_dim,)
  const float* w;      // packed weights
  const int* table;    // (n_layers, kTableCols)
  float* out;          // (rows, D)
  float* skip;         // each CTA's skip stack: (skip_w, rows) column-major with a thread a
                       // row, each row's skip_w values in turn with a warp a row
  int rows, n_layers, D, C, time_dim, skip_w, n_tproj;
  int stage_max;       // values of the largest layer range: one weight buffer
  int nbuf;            // weight buffers: copies run nbuf - 1 layers ahead of the compute
  int ldx, ldh;        // columns of x and of h a row
};

// ops/mega.py::mega_row_smem_bytes mirrors this sizing: the head, the weight
// buffers, the time projections, st and the layer table; and with a thread a
// row the rows' columns of x, h and sc.
size_t smem_bytes(const RowArgs& p, int rows, bool warp) {
  return kHead + sizeof(float) * ((size_t)p.nbuf * p.stage_max + round_up(p.n_tproj, 4) +
                                  round_up(p.time_dim, 4) + (size_t)p.n_layers * kTableCols +
                                  (warp ? 0 : (size_t)rows * (p.ldx + p.ldh + p.C)));
}

// -- the bulk copy and its mbarrier ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory; the copy completes the barrier's
// current phase. The fence orders the CTA's earlier reads of dst (made
// visible to this thread by the barrier before it) before the copy's writes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Copy the range of the packed weights of layer L (a row of the table) into buf.
__device__ __forceinline__ void stage(const RowArgs& p, const int* L, float* buf, uint64_t* bar) {
  bulk_load(buf, p.w + L[K_STAGE], 4u * (uint32_t)L[K_NSTAGE], bar);
}

// -- one row's arithmetic ------------------------------------------------------------

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

struct Norm {
  float mean, inv;
};

// LayerNorm statistics of x[0..width) (the row's columns, nt apart).
__device__ __forceinline__ Norm norm_cols(const float* x, int nt, int width) {
  float s = 0.f;
  for (int k = 0; k < width; ++k) s += x[k * nt];
  const float mean = s / width;
  float q = 0.f;
  for (int k = 0; k < width; ++k) {
    const float d = x[k * nt] - mean;
    q += d * d;
  }
  return {mean, 1.0f / sqrtf(q / width + kLnEps)};
}

// The same of h[0..width) in registers.
template <int N>
__device__ __forceinline__ Norm norm_regs(const float (&h)[N], int width) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < width) s += h[j];
  const float mean = s / width;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < width) {
      const float d = h[j] - mean;
      q += d * d;
    }
  return {mean, 1.0f / sqrtf(q / width + kLnEps)};
}

// acc[j] = fmaf(v, W[j], acc[j]) for every j < N: one row of W (padded with
// zeros to at least N) read as N / 4 broadcast float4s.
template <int N>
__device__ __forceinline__ void fma_row(float (&acc)[N], float v, const float* W) {
  const float4* w = reinterpret_cast<const float4*>(W);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 wq = w[q];
    acc[4 * q + 0] = fmaf(v, wq.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
  }
}

// acc[j] = sum over k < K of x[k] * W[k * ldw + j], fmaf from zero in
// ascending k, for every j < N; x[k] is the row's column k (nt apart).
template <int N>
__device__ __forceinline__ void dense(float (&acc)[N], int K, const float* x, int nt,
                                      const float* W, int ldw) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) fma_row(acc, x[k * nt], W + k * ldw);
}

// The same with x[k] replaced by swish(LN(x)[k] * g[k] + be[k]). The
// activations of kGroup values of k are computed together, their numerators
// and denominators first and the divisions after, so that their latency
// chains overlap (each IEEE division ends in a branch to its slow path,
// which no instruction of the next value's chain can cross).
constexpr int kGroup = 4;

__device__ __forceinline__ float ln_affine(float x, const Norm& n, float g, float be) {
  return (x - n.mean) * n.inv * g + be;
}

template <int N>
__device__ __forceinline__ void dense_act(float (&acc)[N], int K, const float* x, int nt,
                                          const Norm& n, const float* g, const float* be,
                                          const float* W, int ldw) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  int k = 0;
#pragma unroll 1
  for (; k + kGroup <= K; k += kGroup) {
    float v[kGroup], d[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      v[u] = ln_affine(x[(k + u) * nt], n, g[k + u], be[k + u]);
      d[u] = 1.0f + expf(-v[u]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) v[u] = v[u] / d[u];   // swish(v) = v / (1 + exp(-v))
#pragma unroll
    for (int u = 0; u < kGroup; ++u) fma_row(acc, v[u], W + (k + u) * ldw);
  }
#pragma unroll 1
  for (; k < K; ++k) fma_row(acc, swish(ln_affine(x[k * nt], n, g[k], be[k])), W + k * ldw);
}

// The thread's row through one layer of the table. X, H and SC point at the
// row's first column (columns nt apart); wb at the layer's staged range;
// skip at the row's slot of the CTA's stack; orow at the row's output, or
// null for a row past the end.
template <int N>
__device__ __forceinline__ void layer(const int* L, const float* wb, const float* tproj,
                                      float* X, float* H, const float* SC, float* skip,
                                      int nt, int C, float* orow) {
  const int kind = L[K_KIND], in = L[K_IN], out = L[K_OUT];
  const int flags = L[K_FLAGS], ldw = L[K_LDW], base = L[K_STAGE];
  auto at = [&](int col) { return wb + (L[col] - base); };
  float h[N];
  if (kind == FEATURE_PROJ || kind == RESAMPLE) {
    dense(h, in, X, nt, at(K_W1), ldw);
    const float* b = at(K_B1);
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < out) X[j * nt] = h[j] + b[j];
  } else if (kind == HEAD) {
    dense_act(h, in, X, nt, norm_cols(X, nt, in), at(K_G1), at(K_BE1), at(K_W1), ldw);
    const float* b = at(K_B1);
    if (orow != nullptr) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < out) orow[j] = h[j] + b[j];
    }
  } else {   // BLOCK
    if (flags & F_CONCAT) {   // x becomes [x, skip]
      const int sw = L[K_SKIP_W];
      const float* s = skip + L[K_SKIP_OFF] * nt;
      float* x = X + (in - sw) * nt;
      for (int c = 0; c < sw; ++c) x[c * nt] = s[c * nt];
    }
    {   // h = lin1(swish(LN1(x))) + b1 + st @ W_t + b_t
      dense_act(h, in, X, nt, norm_cols(X, nt, in), at(K_G1), at(K_BE1), at(K_W1), ldw);
      const float *b = at(K_B1), *tp = tproj + L[K_TPROJ];
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < out) h[j] = (h[j] + b[j]) + tp[j];
    }
    {   // h = lin2(swish(LN2(h))) + b2 + (sc @ W_c + b_c)
      const Norm n = norm_regs(h, out);
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < out) H[j * nt] = h[j];
      float c[N];
      dense(c, C, SC, nt, at(K_WC), ldw);
      dense_act(h, out, H, nt, n, at(K_G2), at(K_BE2), at(K_W2), ldw);
      const float *b = at(K_B2), *bc = at(K_BC);
#pragma unroll
      for (int j = 0; j < N; ++j) h[j] = (h[j] + b[j]) + (c[j] + bc[j]);
    }
    {   // h = lin3(swish(LN3(h))) + b3, plus the shortcut or x
      const Norm n = norm_regs(h, out);
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < out) H[j * nt] = h[j];
      dense_act(h, out, H, nt, n, at(K_G3), at(K_BE3), at(K_W3), ldw);
      const float* b = at(K_B3);
#pragma unroll
      for (int j = 0; j < N; ++j) h[j] += b[j];
      if (flags & F_SHORTCUT) {
        float s[N];
        dense(s, in, X, nt, at(K_WS), ldw);
        const float* bs = at(K_BS);
#pragma unroll
        for (int j = 0; j < N; ++j) h[j] = h[j] + (s[j] + bs[j]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (j < out) h[j] = h[j] + X[j * nt];
      }
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < out) X[j * nt] = h[j];
    }
  }
  if (flags & F_PUSH) {
    float* s = skip + L[K_SKIP_OFF] * nt;
    for (int c = 0; c < out; ++c) s[c * nt] = X[c * nt];
  }
}

// The CTA's shared memory past the mbarriers: the weight buffers, the time
// projections, st, the layer table, then the layout's own part.
struct Cta {
  uint64_t* bar;
  float* wbuf;
  float* tproj;
  const int* table;
  float* rest;
};

// Set up a CTA that walks `steps` layers: the mbarriers, the table, the
// first nbuf layers' weights in flight, st, and every block's time
// projection st @ W_t + b_t, four entries a thread at once so that their
// loads overlap.
__device__ __forceinline__ Cta cta_setup(const RowArgs& p, unsigned char* smem_raw, int steps) {
  const int nt = blockDim.x, tid = threadIdx.x;
  Cta c;
  c.bar = reinterpret_cast<uint64_t*>(smem_raw);
  c.wbuf = reinterpret_cast<float*>(smem_raw + kHead);
  c.tproj = c.wbuf + p.nbuf * p.stage_max;
  float* st = c.tproj + round_up(p.n_tproj, 4);
  int* table = reinterpret_cast<int*>(st + round_up(p.time_dim, 4));
  c.table = table;
  c.rest = reinterpret_cast<float*>(table + p.n_layers * kTableCols);
  if (tid == 0)
    for (int b = 0; b < p.nbuf; ++b) mbar_init(c.bar + b);
  for (int i = tid; i < p.n_layers * kTableCols; i += nt) table[i] = __ldg(p.table + i);
  for (int i = tid; i < p.time_dim; i += nt) st[i] = p.st[i];
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < p.nbuf && s < steps; ++s)
      stage(p, table + (s % p.n_layers) * kTableCols, c.wbuf + s * p.stage_max, c.bar + s);
  for (int f0 = tid; f0 < p.n_tproj; f0 += 4 * nt) {
    const float* wt[4];
    const float* bt[4];
    int ldw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = min(f0 + i * nt, p.n_tproj - 1);
      const int* L = table;
      for (int li = 0; li < p.n_layers; ++li, L += kTableCols)
        if (L[K_KIND] == BLOCK && f >= L[K_TPROJ] && f < L[K_TPROJ] + L[K_OUT]) break;
      const int j = f - L[K_TPROJ];
      ldw[i] = L[K_LDW];
      wt[i] = p.w + L[K_WT] + j;
      bt[i] = p.w + L[K_BT] + j;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < p.time_dim; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(st[k], __ldg(wt[i] + (size_t)k * ldw[i]), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (f0 + i * nt < p.n_tproj) c.tproj[f0 + i * nt] = acc[i] + __ldg(bt[i]);
  }
  __syncthreads();
  return c;
}

// Layers a CTA of `rows` rows a tile walks (the launcher gives no CTA less
// than one tile).
__device__ __forceinline__ int cta_steps(const RowArgs& p, int rows) {
  const int ntiles = (p.rows + rows - 1) / rows;
  return (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * p.n_layers;
}

// The buffer of a step's layer, once its copy has landed.
__device__ __forceinline__ float* step_weights(const RowArgs& p, const Cta& c, int step) {
  const int b = step % p.nbuf;
  mbar_wait(c.bar + b, (step / p.nbuf) & 1);
  return c.wbuf + b * p.stage_max;
}

// After a step's layer: the CTA's one barrier, then its buffer takes the
// layer nbuf steps on.
__device__ __forceinline__ void step_done(const RowArgs& p, const Cta& c, int step, int steps) {
  __syncthreads();
  if (threadIdx.x == 0 && step + p.nbuf < steps) {
    const int b = step % p.nbuf;
    stage(p, c.table + ((step + p.nbuf) % p.n_layers) * kTableCols, c.wbuf + b * p.stage_max,
          c.bar + b);
  }
}

__global__ void __launch_bounds__(kMaxRows, 1) mega_kernel_rows(const RowArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int steps = cta_steps(p, nt);
  const Cta cta = cta_setup(p, smem_raw, steps);
  float* X = cta.rest + tid;                               // (ldx, nt): x, [x, skip]
  float* H = X + p.ldx * nt;                               // (ldh, nt): h stashed
  float* SC = H + p.ldh * nt;                              // (C, nt): sc
  float* skip = p.skip + (size_t)blockIdx.x * p.skip_w * nt + tid;
  const int ntiles = (p.rows + nt - 1) / nt;
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row = tile * nt + tid;
    const bool live = row < p.rows;
    for (int c = 0; c < p.D; ++c) X[c * nt] = live ? p.y[(size_t)row * p.D + c] : 0.f;
    for (int c = 0; c < p.C; ++c) SC[c * nt] = live ? p.sc[(size_t)row * p.C + c] : 0.f;
    float* orow = live ? p.out + (size_t)row * p.D : nullptr;
    const int* L = cta.table;
    for (int li = 0; li < p.n_layers; ++li, ++step, L += kTableCols) {
      const float* wb = step_weights(p, cta, step);
      const int out = L[K_OUT];
      if (out <= 8)
        layer<8>(L, wb, cta.tproj, X, H, SC, skip, nt, p.C, orow);
      else if (out <= 16)
        layer<16>(L, wb, cta.tproj, X, H, SC, skip, nt, p.C, orow);
      else
        layer<32>(L, wb, cta.tproj, X, H, SC, skip, nt, p.C, orow);
      step_done(p, cta, step, steps);
    }
  }
}

// -- a warp a row: the layout for few rows -----------------------------------------
//
// With few rows, a thread a row leaves most of the card idle and each row's
// forward is one thread's chain of ~125,000 dependent instructions. So up to
// ROW_WARP_MAX_ROWS rows (ops/mega.py) a warp owns a row: a row's vector of
// up to 64 values lies across the warp (value c in lane c % 32, register
// slot c / 32), lane j computes output column j, the activations are
// computed a value a lane and broadcast by shuffles, and LayerNorm sums over
// the warp by mega.cu's tree. The products keep fmaf over k in ascending
// order from zero; the weights, one barrier a layer and the time projections
// are the row-per-thread layout's. The skip stack is a row's contiguous
// slice in device memory.

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm statistics of a row's vector x[0..width), as mega.cu's ln_swish
// takes them: each lane's values in order, then the warp's tree.
__device__ __forceinline__ Norm warp_norm(const float (&x)[2], int width, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (lane + 32 * i < width) s += x[i];
  const float mean = warp_sum(s) / width;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (lane + 32 * i < width) {
      const float d = x[i] - mean;
      q += d * d;
    }
  return {mean, 1.0f / sqrtf(warp_sum(q) / width + kLnEps)};
}

// sum over k < K of a[k] * W[k * ldw + j], fmaf from zero in ascending k,
// for the row's vector a across the warp and this lane's column j.
__device__ __forceinline__ float warp_dense(const float (&a)[2], int K, const float* W, int ldw,
                                            int j) {
  float acc = 0.f;
  const int k32 = min(K, 32);
#pragma unroll 8
  for (int k = 0; k < k32; ++k) acc = fmaf(__shfl_sync(0xffffffffu, a[0], k), W[k * ldw + j], acc);
#pragma unroll 8
  for (int k = 32; k < K; ++k)
    acc = fmaf(__shfl_sync(0xffffffffu, a[1], k - 32), W[k * ldw + j], acc);
  return acc;
}

// The warp's row through one layer: x is the row's vector (0 past its
// width), sc its condition, skip its slice of the stack, orow its output or
// null for a row past the end.
__device__ __forceinline__ void warp_layer(const int* L, const float* wb, const float* tproj,
                                           float (&x)[2], const float (&sc)[2], float* skip,
                                           int C, float* orow, int lane) {
  const int kind = L[K_KIND], in = L[K_IN], out = L[K_OUT];
  const int flags = L[K_FLAGS], ldw = L[K_LDW], base = L[K_STAGE];
  auto at = [&](int col) { return wb + (L[col] - base); };
  const bool mine = lane < out;
  const int j = mine ? lane : 0;   // a column of W for every lane
  float a[2];
  auto act = [&](const float (&v)[2], int width, int cg, int cbe) {   // a = swish(LN(v))
    const Norm n = warp_norm(v, width, lane);
    const float *g = at(cg), *be = at(cbe);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      const float t = c < width ? ln_affine(v[i], n, g[c], be[c]) : 0.f;
      a[i] = t / (1.0f + expf(-t));
    }
  };
  float h;
  if (kind == FEATURE_PROJ || kind == RESAMPLE) {
    h = warp_dense(x, in, at(K_W1), ldw, j) + at(K_B1)[j];
  } else if (kind == HEAD) {
    act(x, in, K_G1, K_BE1);
    h = warp_dense(a, in, at(K_W1), ldw, j) + at(K_B1)[j];
    if (orow != nullptr && mine) orow[lane] = h;
    return;
  } else {
    if (flags & F_CONCAT) {   // x becomes [x, skip]
      const int cur = in - L[K_SKIP_W];
      const float* s = skip + L[K_SKIP_OFF] - cur;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        if (c >= cur && c < in) x[i] = s[c];
      }
    }
    act(x, in, K_G1, K_BE1);
    h = (warp_dense(a, in, at(K_W1), ldw, j) + at(K_B1)[j]) + tproj[L[K_TPROJ] + j];
    float hv[2] = {mine ? h : 0.f, 0.f};
    act(hv, out, K_G2, K_BE2);
    const float c = warp_dense(sc, C, at(K_WC), ldw, j);
    h = (warp_dense(a, out, at(K_W2), ldw, j) + at(K_B2)[j]) + (c + at(K_BC)[j]);
    hv[0] = mine ? h : 0.f;
    act(hv, out, K_G3, K_BE3);
    h = warp_dense(a, out, at(K_W3), ldw, j) + at(K_B3)[j];
    h = (flags & F_SHORTCUT) ? h + (warp_dense(x, in, at(K_WS), ldw, j) + at(K_BS)[j])
                             : h + x[0];
  }
  x[0] = mine ? h : 0.f;
  x[1] = 0.f;
  if ((flags & F_PUSH) && mine) skip[L[K_SKIP_OFF] + lane] = x[0];
}

__global__ void __launch_bounds__(kMaxWarpRows * 32) mega_kernel_rows_warp(const RowArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int steps = cta_steps(p, nw);
  const Cta cta = cta_setup(p, smem_raw, steps);
  float* skip = p.skip + ((size_t)blockIdx.x * nw + warp) * p.skip_w;
  const int ntiles = (p.rows + nw - 1) / nw;
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row = tile * nw + warp;
    const bool live = row < p.rows;   // the same across the warp
    float x[2] = {live && lane < p.D ? p.y[(size_t)row * p.D + lane] : 0.f, 0.f};
    float sc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sc[i] = live && lane + 32 * i < p.C ? p.sc[(size_t)row * p.C + lane + 32 * i] : 0.f;
    float* orow = live ? p.out + (size_t)row * p.D : nullptr;
    const int* L = cta.table;
    for (int li = 0; li < p.n_layers; ++li, ++step, L += kTableCols) {
      const float* wb = step_weights(p, cta, step);
      if (live) warp_layer(L, wb, cta.tproj, x, sc, skip, p.C, orow, lane);
      step_done(p, cta, step, steps);
    }
  }
}

int g_last_launch[3] = {0, 0, 0};   // rows a CTA, grid, shared-memory bytes

}  // namespace

// Launches the row-resident forward on `stream` over `grid` CTAs of
// `cta_rows` rows: with `warp` 0 a thread a row (cta_rows a multiple of 32
// up to kMaxRows), with `warp` 1 a warp a row (cta_rows warps, up to
// kMaxWarpRows). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a net, a CTA or a buffer the kernel does not
// take). Float32 only. The caller guarantees contiguous arrays, a table and
// weights from ops/mega.py::pack_params (each layer's staged range
// contiguous, every array 64-byte aligned, the buffer 16-byte aligned),
// grid <= ceil(rows / cta_rows), and grid * cta_rows * skip_w floats of
// skip scratch.
extern "C" int diffsg_unet_mega_rows(const float* y, const float* sc, const float* st,
                                     const float* w, const int* table, float* out, float* skip,
                                     int rows, int n_layers, int D, int C, int time_dim,
                                     int skip_w, int max_in, int max_out, int n_tproj,
                                     int stage_max, int warp, int cta_rows, int grid,
                                     void* stream) {
  const int ldx = std::max({max_in, max_out, D});
  // A warp a row keeps no rows in shared memory, so its copies run further ahead.
  const RowArgs p{y, sc, st, w, table, out, skip, rows, n_layers, D, C, time_dim, skip_w,
                  n_tproj, stage_max, warp ? kMaxBuffers : 2, ldx, max_out};
  const size_t smem = smem_bytes(p, cta_rows, warp);
  const bool cta_ok = warp ? cta_rows >= 1 && cta_rows <= kMaxWarpRows && C <= 2 * 32
                           : cta_rows >= 32 && cta_rows <= kMaxRows && cta_rows % 32 == 0;
  if (max_in > kMaxIn || max_out > kMaxOut || D > kMaxOut || !cta_ok || stage_max % 16 ||
      smem > kSmemMax || grid < 1 || grid > (rows + cta_rows - 1) / cta_rows ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  const void* kernel = warp ? (const void*)mega_kernel_rows_warp : (const void*)mega_kernel_rows;
  static size_t smem_opt_in[2] = {48 * 1024, 48 * 1024};
  if (smem > smem_opt_in[warp]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_opt_in[warp] = smem;
  }
  g_last_launch[0] = cta_rows, g_last_launch[1] = grid, g_last_launch[2] = (int)smem;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warp)
    mega_kernel_rows_warp<<<grid, 32 * cta_rows, smem, s>>>(p);
  else
    mega_kernel_rows<<<grid, cta_rows, smem, s>>>(p);
  return cudaGetLastError();
}

// The rows a CTA, grid size and shared-memory bytes of the last launch.
extern "C" void diffsg_unet_mega_rows_last_launch(int* info) {
  for (int i = 0; i < 3; ++i) info[i] = g_last_launch[i];
}

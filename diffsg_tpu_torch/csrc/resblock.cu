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
// with LayerNorm eps 1e-5 and a two-pass variance, all in float32.
//
// Bound on an H100: float32 SIMT operations. The widest block of the MSR-3c
// net (256 -> 128 with shortcut) at 2B = 16,384 rows is 3.2 GFLOP, about
// 48 us at 67 TFLOP/s, against 25 MB of activations, about 7.5 us at
// 3.35 TB/s. This first design does nothing yet about that bound: no tensor
// cores, no staging of the weights in shared memory.
//
// Design. One CTA of 256 threads per tile of 32 rows; the grid covers the
// ragged tail with a row mask. The x tile, the activated tile
// a = swish(LN(.)) and the running h tile stay in dynamic shared memory
// (32 x (in + max(in, out) + out) floats, 80 KB for 256 -> 128). LayerNorm
// statistics are per row, one warp per row, reduced with shuffles; lanes
// past the width add zero, which masks widths 8 and 16. The products read
// the weights from global memory (they stay in L2: 6.2 MB for the whole
// net) in their (in, out) layout, W[k * out + j]: a thread owns output
// column j for RPT rows of the tile, so a warp reads 32 neighbouring
// columns of one weight row and broadcasts one float4 of the activation
// row from shared memory per four steps of k.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;
constexpr float kLnEps = 1e-5f;

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

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r, :] = swish(LN(src[r, :]) * g + be) for every row of the tile.
__device__ void ln_swish(const float* src, float* dst, int width,
                         const float* __restrict__ g, const float* __restrict__ be) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTileRows; r += kThreads / 32) {
    const float* s = src + r * width;
    float sum = 0.f;
    for (int k = lane; k < width; k += 32) sum += s[k];
    const float mean = warp_sum(sum) / width;
    float sq = 0.f;
    for (int k = lane; k < width; k += 32) {
      const float d = s[k] - mean;
      sq += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(sq) / width + kLnEps);
    float* d = dst + r * width;
    for (int k = lane; k < width; k += 32)
      d[k] = swish((s[k] - mean) * inv * __ldg(g + k) + __ldg(be + k));
  }
}

// acc = a[r, :] @ W[:, j] for the tile; epi(r, j, acc) consumes each result.
// RPT rows per thread: 32 / RPT row groups, 8 * RPT column threads.
template <int RPT, class Epilogue>
__device__ __forceinline__ void tile_matmul(const float* a, int K,
                                            const float* __restrict__ W, int N,
                                            Epilogue epi) {
  constexpr int kGroups = kTileRows / RPT;
  constexpr int kCols = kThreads / kGroups;
  const int tcol = threadIdx.x % kCols, rg = threadIdx.x / kCols;
  for (int j = tcol; j < N; j += kCols) {
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float w0 = __ldg(W + (size_t)(k + 0) * N + j);
      const float w1 = __ldg(W + (size_t)(k + 1) * N + j);
      const float w2 = __ldg(W + (size_t)(k + 2) * N + j);
      const float w3 = __ldg(W + (size_t)(k + 3) * N + j);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + (rg + i * kGroups) * K + k);
        acc[i] = fmaf(v.x, w0, acc[i]);
        acc[i] = fmaf(v.y, w1, acc[i]);
        acc[i] = fmaf(v.z, w2, acc[i]);
        acc[i] = fmaf(v.w, w3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) epi(rg + i * kGroups, j, acc[i]);
  }
}

template <int RPT>
__global__ void __launch_bounds__(kThreads) resblock_kernel(const ResblockArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int in = p.in_dim, out = p.out_dim;
  const int wide = in > out ? in : out;
  float* xs = smem;                  // (32, in)   raw x tile
  float* a = xs + kTileRows * in;    // (32, wide) swish(LN(.)) of the current stage
  float* h = a + kTileRows * wide;   // (32, out)  running block state
  const int row0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, p.rows - row0);

  // x tile, zero past the ragged edge (LN of a zero row stays finite).
  const float4* xg = reinterpret_cast<const float4*>(p.x + (size_t)row0 * in);
  const int in4 = in / 4;
  for (int idx = threadIdx.x; idx < kTileRows * in4; idx += kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx / in4 < nrows) v = xg[idx];
    reinterpret_cast<float4*>(xs)[idx] = v;
  }
  __syncthreads();

  ln_swish(xs, a, in, p.g1, p.be1);
  __syncthreads();
  tile_matmul<RPT>(a, in, p.w1, out, [&](int r, int j, float acc) {
    const float t = r < nrows ? __ldg(p.t_proj + (size_t)(row0 + r) * p.t_stride + j) : 0.f;
    h[r * out + j] = (acc + __ldg(p.b1 + j)) + t;
  });
  __syncthreads();

  ln_swish(h, a, out, p.g2, p.be2);
  __syncthreads();
  tile_matmul<RPT>(a, out, p.w2, out, [&](int r, int j, float acc) {
    const float c = r < nrows ? __ldg(p.c_proj + (size_t)(row0 + r) * out + j) : 0.f;
    h[r * out + j] = (acc + __ldg(p.b2 + j)) + c;
  });
  __syncthreads();

  ln_swish(h, a, out, p.g3, p.be3);
  __syncthreads();
  tile_matmul<RPT>(a, out, p.w3, out, [&](int r, int j, float acc) {
    h[r * out + j] = acc + __ldg(p.b3 + j);
  });
  __syncthreads();

  if (p.ws != nullptr) {
    tile_matmul<RPT>(xs, in, p.ws, out, [&](int r, int j, float acc) {
      if (r < nrows) p.out[(size_t)(row0 + r) * out + j] = h[r * out + j] + (acc + __ldg(p.bs + j));
    });
  } else {
    for (int idx = threadIdx.x; idx < nrows * out; idx += kThreads)
      p.out[(size_t)row0 * out + idx] = h[idx] + xs[idx];
  }
}

template <int RPT>
cudaError_t launch(const ResblockArgs& p, cudaStream_t stream) {
  const int wide = p.in_dim > p.out_dim ? p.in_dim : p.out_dim;
  const int smem = (int)sizeof(float) * kTileRows * (p.in_dim + wide + p.out_dim);
  // The opt-in above 48 KB is per kernel; raise it once to the largest size seen.
  static int smem_opt_in = 48 * 1024;
  if (smem > smem_opt_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        resblock_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_opt_in = smem;
  }
  const dim3 grid((p.rows + kTileRows - 1) / kTileRows);
  resblock_kernel<RPT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches the fused block on `stream`; returns the cudaError_t of the launch.
// The caller guarantees: float32, contiguous, in_dim and out_dim multiples of
// 4, x 16-byte aligned, and ws/bs both null exactly when in_dim == out_dim.
extern "C" int diffsg_resblock_f32(
    const float* x, const float* t_proj, int t_stride, const float* c_proj,
    const float* g1, const float* be1, const float* w1, const float* b1,
    const float* g2, const float* be2, const float* w2, const float* b2,
    const float* g3, const float* be3, const float* w3, const float* b3,
    const float* ws, const float* bs, float* out,
    int rows, int in_dim, int out_dim, void* stream) {
  const ResblockArgs p{x, t_proj, c_proj, g1, be1, w1, b1, g2, be2, w2, b2,
                       g3, be3, w3, b3, ws, bs, out, rows, in_dim, out_dim, t_stride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Rows per thread: enough column threads (8 * RPT) to cover out_dim once,
  // up to 256 columns; wider outputs loop over column passes.
  if (out_dim <= 8) return launch<1>(p, s);
  if (out_dim <= 16) return launch<2>(p, s);
  if (out_dim <= 32) return launch<4>(p, s);
  if (out_dim <= 64) return launch<8>(p, s);
  if (out_dim <= 128) return launch<16>(p, s);
  return launch<32>(p, s);
}

extern "C" const char* diffsg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

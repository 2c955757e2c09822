// K5: grouped GEMMs over the routed experts' row segments, float32.
//
// Replaces no TPU kernel: the JAX package has no routed layer. It was added
// for the DeepSeek-V2 caption tower (models/deepseek_v2.py), whose MoE
// layers send each valid token to 6 of 64 experts. The (token, slot) rows
// are sorted by expert on the device (ops/moe.py `route`), so expert e owns
// the rows [off[e], off[e + 1]) of the sorted activations, and the rows
// from off[E] to R are pad slots (pad tokens are not routed). The segment
// offsets are read here from device memory: no count ever reaches the
// host, so a CUDA graph captures the launches once and replays them over
// any routing.
//
//   moe_rows   C[r] = A[r] W[e(r)]^T (mode NT) or A[r] W[e(r)] (mode NN)
//              over the rows of every segment, with an epilogue:
//     0 NT store        C (R, N)
//     1 NT SwiGLU       W = [gate; up] (E, 2F, K): gu (R, 2F) the
//                       pre-activations, act (R, F) = silu(gate) * up
//     2 NN store        C (R, N)
//     3 NN dSwiGLU      da = A W[e] (R, F), then with gu the forward's
//                       pre-activations: dgu[:, :F] = da * up * silu'(gate),
//                       dgu[:, F:] = da * silu(gate)
//     Rows from off[E] to R get zeros in every output (the pad slots), so
//     nothing downstream reads an unwritten row.
//   moe_wgrad  dW[e] += G[seg e]^T X[seg e], in place: the weight gradient
//              summed over the segment's rows and added to the gradient
//              that the earlier microbatches of the update left there.
//
// Grids are fixed by the shapes, not the routing. moe_rows has
// ceil(R / 64) + E + 1 row tiles, the most that the segments and the pad
// rows can need together; a block finds its (expert, tile) by walking the
// offsets and leaves at once if it has none. moe_wgrad has one block per
// (expert, 64 x 128 tile of dW), which loops over the expert's rows and
// returns at once for an expert without rows. No atomics: every output
// element is written by one block, summed in a fixed order, so a replay
// gives the bits of the eager call.
//
// Design. Plain FFMA in float32 (no TF32, no tensor cores: the recipe
// computes in float32). A block of 256 threads owns a 64-row x 128-column
// tile; each thread holds a 4 x 8 tile of sums, its columns in two groups
// of 4 at a stride of 64 (for the SwiGLU epilogue: the gate column and its
// up column fall to the same thread). Both operands are staged in shared
// memory 16 values of the reduction deep, as float4 reads for the thread's
// operands; the next stage's global loads are in flight in registers while
// the current one is multiplied. Edges (rows past a segment's end, columns
// past N, the reduction past K) are masked with zeros; K and N must be
// multiples of 4 (float4 loads).
//
// Bound on an H100 at the dsv2.train cell's shapes (E = 64, F = 1408,
// D = 2048, about 51 rows an expert a microbatch): 2 r D 2F + 2 r F D
// FLOP forward and twice that backward, at 67 TFLOP/s; and the experts'
// weights (2.2 GB) read forward and again for dX, and their gradients
// read and written by dW (4.4 GB), at 3.35 TB/s. At 51 rows an expert the
// two bounds are about equal: the kernel sits at the float32 ridge, and
// the row tile of 64 wastes the rest of a tile where a segment is short.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // rows (moe_rows) or dW rows (moe_wgrad)
constexpr int BN = 128;         // output columns
constexpr int BK = 16;          // reduction depth of a stage
constexpr int THREADS = 256;
constexpr int PAD = 4;          // shared-memory row padding (floats)

enum Mode { NT_STORE = 0, NT_SWIGLU = 1, NN_STORE = 2, NN_DSWIGLU = 3 };

// The row tile `t` of the grid: the segment it lies in (expert e, or -1 for
// the pad rows), its first row and the segment's end. False: no tile.
__device__ __forceinline__ bool find_tile(const int64_t* __restrict__ off,
                                          int E, int64_t R, int t, int& e,
                                          int64_t& row0, int64_t& row_end) {
  int seen = 0;
  for (int i = 0; i < E; ++i) {
    const int64_t lo = __ldg(off + i), hi = __ldg(off + i + 1);
    const int n = static_cast<int>((hi - lo + BM - 1) / BM);
    if (t < seen + n) {
      e = i;
      row0 = lo + static_cast<int64_t>(t - seen) * BM;
      row_end = hi;
      return true;
    }
    seen += n;
  }
  const int64_t lo = __ldg(off + E);
  const int n = static_cast<int>((R - lo + BM - 1) / BM);
  if (t < seen + n) {
    e = -1;
    row0 = lo + static_cast<int64_t>(t - seen) * BM;
    row_end = R;
    return true;
  }
  return false;
}

__device__ __forceinline__ float silu_of(float g) {
  return g / (1.0f + expf(-g));
}

// The weight column that tile column `c` (0..BN) of column tile `ct`
// stands for, or -1 past the edge. SwiGLU: the first half of the tile is
// gate columns, the second half the matching up columns (F further on).
template <int MODE>
__device__ __forceinline__ int weight_col(int ct, int c, int N) {
  if (MODE == NT_SWIGLU) {
    const int j = ct * (BN / 2) + (c < BN / 2 ? c : c - BN / 2);
    return j < N ? (c < BN / 2 ? j : N + j) : -1;
  }
  const int n = ct * BN + c;
  return n < N ? n : -1;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
moe_rows_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const int64_t* __restrict__ off, int E, int64_t R, int N,
                int K, float* __restrict__ C, float* __restrict__ C2,
                const float* __restrict__ GU) {
  constexpr bool NN = (MODE == NN_STORE || MODE == NN_DSWIGLU);
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  int e;
  int64_t row0, row_end;
  if (!find_tile(off, E, R, blockIdx.x, e, row0, row_end)) return;
  const int ct = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // the widths of the outputs: SwiGLU and dSwiGLU write (R, 2F) with N = F
  const int64_t ldc = (MODE == NT_SWIGLU || MODE == NN_DSWIGLU) ? 2LL * N : N;

  if (e < 0) {                       // pad rows: zeros in every output
    for (int i = 0; i < 4; ++i) {
      const int64_t r = row0 + ty * 4 + i;
      if (r >= row_end) break;
      for (int h = 0; h < 2; ++h)
        for (int j = 0; j < 4; ++j) {
          const int c = h * (BN / 2) + tx * 4 + j;
          if (MODE == NT_SWIGLU) {
            const int n = weight_col<MODE>(ct, c, N);
            if (n < 0) continue;
            C[r * ldc + n] = 0.0f;
            if (h == 0) C2[r * N + n] = 0.0f;
          } else {
            const int n = weight_col<MODE>(ct, c, N);
            if (n < 0) continue;
            C[r * ldc + n] = 0.0f;
            if (MODE == NN_DSWIGLU) C[r * ldc + N + n] = 0.0f;
          }
        }
    }
    return;
  }

  // the whole weight matrix of expert e: (Nw, K) for NT, (K, N) for NN
  const int64_t nw = (MODE == NT_SWIGLU) ? 2LL * N : N;
  const float* We = W + static_cast<int64_t>(e) * nw * K;

  // global -> register staging: one float4 of A and two of W a thread
  float4 ra, rb[2];
  auto load = [&](int k0) {
    {
      const int r = tid / 4, k = (tid % 4) * 4;
      const int64_t row = row0 + r;
      ra = (row < row_end && k0 + k < K)
               ? __ldg(reinterpret_cast<const float4*>(A + row * K + k0 + k))
               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = tid + h * THREADS;
      if (NN) {
        const int k = idx / 32, c = (idx % 32) * 4;
        const int n = ct * BN + c;
        rb[h] = (k0 + k < K && n < N)
                    ? __ldg(reinterpret_cast<const float4*>(
                          We + static_cast<int64_t>(k0 + k) * N + n))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int c = idx / 4, k = (idx % 4) * 4;
        const int n = weight_col<MODE>(ct, c, N);
        rb[h] = (n >= 0 && k0 + k < K)
                    ? __ldg(reinterpret_cast<const float4*>(
                          We + static_cast<int64_t>(n) * K + k0 + k))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto store = [&]() {
    {
      const int r = tid / 4, k = (tid % 4) * 4;
      As[k + 0][r] = ra.x;
      As[k + 1][r] = ra.y;
      As[k + 2][r] = ra.z;
      As[k + 3][r] = ra.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = tid + h * THREADS;
      if (NN) {
        const int k = idx / 32, c = (idx % 32) * 4;
        *reinterpret_cast<float4*>(&Bs[k][c]) = rb[h];
      } else {
        const int c = idx / 4, k = (idx % 4) * 4;
        Bs[k + 0][c] = rb[h].x;
        Bs[k + 1][c] = rb[h].y;
        Bs[k + 2][c] = rb[h].z;
        Bs[k + 3][c] = rb[h].w;
      }
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty * 4 + i;
    if (r >= row_end) break;
    if (MODE == NT_SWIGLU) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = weight_col<MODE>(ct, tx * 4 + j, N);
        if (n < 0) continue;
        const float g = acc[i][j], u = acc[i][4 + j];
        C[r * ldc + n] = g;
        C[r * ldc + N + n] = u;
        C2[r * N + n] = silu_of(g) * u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j < 4 ? 0 : BN / 2) + tx * 4 + (j & 3);
        const int n = weight_col<MODE>(ct, c, N);
        if (n < 0) continue;
        if (MODE == NN_DSWIGLU) {
          const float g = GU[r * ldc + n], u = GU[r * ldc + N + n];
          const float s = 1.0f / (1.0f + expf(-g));
          const float da = acc[i][j];
          C[r * ldc + n] = da * u * (s * (1.0f + g * (1.0f - s)));
          C[r * ldc + N + n] = da * (g * s);
        } else {
          C[r * ldc + n] = acc[i][j];
        }
      }
    }
  }
}

// dW[e] (N, Kw) += G[rows of e]^T (N x rows) X[rows of e] (rows x Kw)
__global__ void __launch_bounds__(THREADS)
moe_wgrad_kernel(const float* __restrict__ G, int N,
                 const float* __restrict__ X, int Kw,
                 const int64_t* __restrict__ off, float* __restrict__ dW) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int e = blockIdx.z;
  const int64_t lo = __ldg(off + e), hi = __ldg(off + e + 1);
  if (lo >= hi) return;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float4 ra, rb[2];
  auto load = [&](int64_t r0) {
    {
      const int k = tid / 16, m = (tid % 16) * 4;
      ra = (r0 + k < hi && m0 + m < N)
               ? __ldg(reinterpret_cast<const float4*>(G + (r0 + k) * N +
                                                       m0 + m))
               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = tid + h * THREADS;
      const int k = idx / 32, n = (idx % 32) * 4;
      rb[h] = (r0 + k < hi && n0 + n < Kw)
                  ? __ldg(reinterpret_cast<const float4*>(X + (r0 + k) * Kw +
                                                          n0 + n))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&]() {
    {
      const int k = tid / 16, m = (tid % 16) * 4;
      *reinterpret_cast<float4*>(&As[k][m]) = ra;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = tid + h * THREADS;
      const int k = idx / 32, n = (idx % 32) * 4;
      *reinterpret_cast<float4*>(&Bs[k][n]) = rb[h];
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(lo);
  for (int64_t r0 = lo; r0 < hi; r0 += BK) {
    store();
    __syncthreads();
    if (r0 + BK < hi) load(r0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dWe = dW + static_cast<int64_t>(e) * N * Kw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= N) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      if (n >= Kw) continue;
      float4* p = reinterpret_cast<float4*>(dWe + static_cast<int64_t>(m) * Kw +
                                            n);
      float4 v = *p;
      v.x += acc[i][h * 4 + 0];
      v.y += acc[i][h * 4 + 1];
      v.z += acc[i][h * 4 + 2];
      v.w += acc[i][h * 4 + 3];
      *p = v;
    }
  }
}

}  // namespace

// A (R, K) rows sorted by expert; W (E, N, K) for the NT modes ((E, 2N, K)
// for SwiGLU), (E, K, N) for the NN modes; off (E + 1) int64 on the
// device; C (R, N), or (R, 2N) for SwiGLU and dSwiGLU; C2 the SwiGLU's act
// (R, N); GU the forward's (R, 2N) pre-activations for dSwiGLU.
extern "C" int moe_rows(const void* A, const void* W, const void* off, int E,
                        long long R, int N, int K, int mode, void* C, void* C2,
                        const void* GU, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || R < 0 || N < 1 || K < 0 || (K % 4) || (N % 4) || mode < 0 ||
      mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const int tiles = static_cast<int>((R + BM - 1) / BM) + E + 1;
  const int cols = (mode == NT_SWIGLU) ? (N + BN / 2 - 1) / (BN / 2)
                                        : (N + BN - 1) / BN;
  const dim3 grid(tiles, cols);
  const float* a = static_cast<const float*>(A);
  const float* w = static_cast<const float*>(W);
  const int64_t* o = static_cast<const int64_t*>(off);
  float* c = static_cast<float*>(C);
  float* c2 = static_cast<float*>(C2);
  const float* gu = static_cast<const float*>(GU);
  switch (mode) {
    case NT_STORE:
      moe_rows_kernel<NT_STORE><<<grid, THREADS, 0, s>>>(a, w, o, E, R, N, K,
                                                         c, c2, gu);
      break;
    case NT_SWIGLU:
      moe_rows_kernel<NT_SWIGLU><<<grid, THREADS, 0, s>>>(a, w, o, E, R, N, K,
                                                          c, c2, gu);
      break;
    case NN_STORE:
      moe_rows_kernel<NN_STORE><<<grid, THREADS, 0, s>>>(a, w, o, E, R, N, K,
                                                         c, c2, gu);
      break;
    default:
      moe_rows_kernel<NN_DSWIGLU><<<grid, THREADS, 0, s>>>(a, w, o, E, R, N,
                                                           K, c, c2, gu);
  }
  return static_cast<int>(cudaGetLastError());
}

// G (R, N), X (R, Kw) rows sorted by expert; dW (E, N, Kw), added to.
extern "C" int moe_wgrad(const void* G, const void* X, const void* off, int E,
                         int N, int Kw, void* dW, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || N < 1 || Kw < 1 || (N % 4) || (Kw % 4) || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Kw + BN - 1) / BN, (N + BM - 1) / BM, E);
  moe_wgrad_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(G), N, static_cast<const float*>(X), Kw,
      static_cast<const int64_t*>(off), static_cast<float*>(dW));
  return static_cast<int>(cudaGetLastError());
}

// Cosine scores of brands against posts -- the JAX package's Pallas kernel
// `cosine_scores_pallas` (fancyrec_tpu/ops/similarity.py,
// `_cosine_block_kernel`).
//
//   bn    (B, D) float32  brands, each row already divided by its L2 norm
//   posts (N, D) float32  raw post embeddings
//   ->    out (B, N) float32,
//         out[b, n] = dot(bn[b], posts[n]) * rsqrt(sum_d posts[n, d]^2)
//
// Each post row is normalised on the fly: its sum of squares is taken while
// the row streams through, and the scale is applied in the epilogue, so no
// normalised copy of the posts is ever written. A real all-zero post row
// gives rsqrt(0) = inf times a zero dot, NaN, as both JAX functions give;
// an all-zero brand row arrives as NaN from the caller's 0/0. The sums are
// reduced into shared memory stage by stage (a warp shuffle over the 8
// lanes that staged a row's columns), which keeps the kernel under the
// two-blocks-an-SM register cap without spills; held in registers until
// the end, they cost 16 more a thread and spilled.
//
// Design. The TPU kernel takes a (512, D) post block per sequential grid
// step and one matrix-unit product. Here a block owns a tile of 128 posts
// and 64 brands (B = 51 pads to one brand tile), walks D in stages of 32,
// and stages both operands in shared memory, transposed so that a thread's
// operands are 16-byte loads: each of the 256 threads holds a 4-brand x
// 8-post tile of float32 sums (plain FFMA, no TF32) and reads one brand
// float4 and two post float4s per step of D. The next stage's global loads
// are in flight in registers while the current stage is multiplied. The
// ragged last post tile, brand tile and D stage are masked with zeros and
// never stored; no padding is needed by the caller.
//
// Bound on an H100 at the 1M-post evaluation (B=51, N=1,000,000, D=1024):
// 104.4 G float32 FLOP take 1.56 ms at 67 TFLOP/s; the 4.1 GB of posts and
// the 0.2 GB of scores move in 1.28 ms at 3.35 TB/s. So it is bound by
// operations, barely: the design keeps the posts to one pass from device
// memory and spends its effort on keeping the FMA pipes fed from registers.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 64;          // brands per block
constexpr int TN = 128;         // posts per block
constexpr int KC = 32;          // D values per stage
constexpr int THREADS = 256;    // 16 x 16 threads, 4 brands x 8 posts each
constexpr int AS = TB + 4;      // transposed brand stage row, floats
constexpr int PS = TN + 4;      // transposed post stage row, floats
constexpr int A_LD = TB * KC / THREADS;   // brand values a thread stages: 8
constexpr int P_LD = TN * KC / THREADS;   // post values a thread stages: 16

// Staging map: a warp instruction reads a block of 4 rows x 8 columns (four
// 32-byte sectors). Thread element q lies in row row0 + 8q, column `col`,
// the same for both operands. The transposed shared-memory stores hit 32
// distinct banks: (4 * col + row) mod 32 over the warp's lanes.
__device__ __forceinline__ void load_stage(
    const float* __restrict__ bn, const float* __restrict__ posts, int b0,
    int n0, int k0, int row0, int col, int B, int N, int D,
    float (&br)[A_LD], float (&pr)[P_LD]) {
  const int d = k0 + col;
#pragma unroll
  for (int q = 0; q < A_LD; ++q) {
    const int b = b0 + row0 + 8 * q;
    br[q] = (b < B && d < D) ? bn[(size_t)b * D + d] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < P_LD; ++q) {
    const int n = n0 + row0 + 8 * q;
    pr[q] = (n < N && d < D) ? posts[(size_t)n * D + d] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS, 2) cosine_scores_kernel(
    const float* __restrict__ bn, const float* __restrict__ posts,
    float* __restrict__ out, int B, int N, int D) {
  __shared__ __align__(16) float as[KC * AS];     // [k][brand]
  __shared__ __align__(16) float ps[KC * PS];     // [k][post]
  __shared__ float part[4][TN];
  __shared__ float inv[TN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;         // 8 posts, 4 brands
  const int b0 = blockIdx.y * TB;
  const int n0 = blockIdx.x * TN;
  const int row0 = (warp >> 2) * 4 + (lane >> 3);
  const int col = (warp & 3) * 8 + (lane & 7);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // part[g][r]: post row r's sum of squares over column group g of every
  // stage, owned (zeroed and added to) by one lane of one warp
  if ((lane & 7) == 0)
#pragma unroll
    for (int q = 0; q < P_LD; ++q) part[warp & 3][row0 + 8 * q] = 0.0f;

  float br[A_LD], pr[P_LD];
  load_stage(bn, posts, b0, n0, 0, row0, col, B, N, D, br, pr);
  for (int k0 = 0; k0 < D; k0 += KC) {
#pragma unroll
    for (int q = 0; q < A_LD; ++q) as[col * AS + row0 + 8 * q] = br[q];
#pragma unroll
    for (int q = 0; q < P_LD; ++q) {
      ps[col * PS + row0 + 8 * q] = pr[q];
      // the row's squares over this stage's 8 columns of the group
      float v = pr[q] * pr[q];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if ((lane & 7) == 0) part[warp & 3][row0 + 8 * q] += v;
    }
    __syncthreads();
    // the next stage's loads are in flight during these products
    if (k0 + KC < D)
      load_stage(bn, posts, b0, n0, k0 + KC, row0, col, B, N, D, br, pr);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k * AS + ty * 4]);
      const float4 p = *reinterpret_cast<const float4*>(&ps[k * PS + tx * 4]);
      const float4 r = *reinterpret_cast<const float4*>(&ps[k * PS + 64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float pv[8] = {p.x, p.y, p.z, p.w, r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], pv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < TN) inv[tid] = rsqrtf(part[0][tid] + part[1][tid] + part[2][tid] + part[3][tid]);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) break;
    float* orow = out + (size_t)b * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j / 4) * 64 + tx * 4 + j % 4;
      if (n0 + c < N) orow[n0 + c] = acc[i][j] * inv[c];
    }
  }
}

}  // namespace

// bn (B, D) and posts (N, D) contiguous float32, out (B, N) float32; B, N
// >= 1. Returns cudaGetLastError() after the launch (0 on success).
// Launches on `stream`, does not synchronise.
extern "C" int cosine_scores_fwd(const void* bn, const void* posts, void* out,
                                 int B, int N, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + TN - 1) / TN, (B + TB - 1) / TB);
  cosine_scores_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(bn), static_cast<const float*>(posts),
      static_cast<float*>(out), B, N, D);
  return static_cast<int>(cudaGetLastError());
}

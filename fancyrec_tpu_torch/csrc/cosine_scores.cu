// Cosine scores of brands against posts -- the JAX package's Pallas kernel
// `cosine_scores_pallas` (fancyrec_tpu/ops/similarity.py,
// `_cosine_block_kernel`).
//
//   brands (B, D) float32  brand embeddings: for the single pass bn, the
//                          rows divided by their norms (by the caller); for
//                          the D-split path the raw rows
//   posts  (N, D) float32  raw post embeddings
//   ->     out (B, N) float32,
//          out[b, n] = dot(bn[b], posts[n]) * rsqrt(sum_d posts[n, d]^2),
//          bn[b] = brands[b] / ||brands[b]||
//
// Each post row is normalised on the fly: its sum of squares is taken while
// the row streams through, and the scale is applied in the epilogue, so no
// normalised copy of the posts is ever written. A real all-zero post row
// gives rsqrt(0) = inf times a zero dot, NaN, as both JAX functions give;
// an all-zero brand row is NaN from its division by its norm (0/0). The
// sums are reduced into shared memory stage by stage (a warp shuffle over
// the 8 lanes that staged a row's columns), which keeps the kernel under
// the two-blocks-an-SM register cap without spills; held in registers
// until the end, they cost 16 more a thread and spilled.
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
//
// Few posts. The test split's 816 posts make ceil(816 / 128) = 7 tiles: 7
// blocks on 132 SMs, each walking all 32 D stages in turn. There the caller
// splits D into S slices of whole stages (`cosine_slices` in
// ops/similarity.py picks S so that the tiles times S fill the card), and a
// block (tile, slice) writes its partial dots of the raw brands (S, B, N)
// and its post rows' partial sums of squares (S, N) to float32 scratch. A
// second kernel takes the brand's norm, adds the S partials of each score
// in slice order, applies both scales and writes out; it is launched with
// programmatic dependent launch, so its blocks are resident, their brand
// norms taken, when the first kernel's last blocks end. Taking the norm
// there spares the caller's two PyTorch calls, whose host time is more
// than the card's part of a call at this size. No atomics: a call gives the
// same bits run to run. At scale (S = 1) the single pass runs alone.

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

// SPLIT: block z takes D values [z * kslice, min(D, (z + 1) * kslice)) and
// writes dots[z, b, n] and sqs[z, n] (one brand tile writes the latter)
// instead of out; kslice is a multiple of KC. There `bn` holds the raw
// brands: the adding kernel divides by their norms.
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 2) cosine_scores_kernel(
    const float* __restrict__ bn, const float* __restrict__ posts,
    float* __restrict__ out, float* __restrict__ dots,
    float* __restrict__ sqs, int B, int N, int D, int kslice) {
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
  const int kbeg = SPLIT ? static_cast<int>(blockIdx.z) * kslice : 0;
  const int kend = SPLIT ? min(D, kbeg + kslice) : D;
  if constexpr (SPLIT)   // the adding kernel may start; it waits for all
    asm volatile("griddepcontrol.launch_dependents;");

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
  load_stage(bn, posts, b0, n0, kbeg, row0, col, B, N, D, br, pr);
  for (int k0 = kbeg; k0 < kend; k0 += KC) {
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
    if (k0 + KC < kend)
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

  if constexpr (SPLIT) {
    const size_t z = blockIdx.z;
    if (blockIdx.y == 0 && tid < TN && n0 + tid < N)
      sqs[z * N + n0 + tid] =
          part[0][tid] + part[1][tid] + part[2][tid] + part[3][tid];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty * 4 + i;
      if (b >= B) break;
      float* drow = dots + (z * B + b) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j / 4) * 64 + tx * 4 + j % 4;
        if (n0 + c < N) drow[n0 + c] = acc[i][j];
      }
    }
    return;
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

constexpr int NORM_THREADS = 256;

// grid (ceil(N / NORM_THREADS), B): out[b, n] = (sum_z dots[z, b, n]) /
// ||brands[b]|| * rsqrt(sum_z sqs[z, n]), each sum in slice order. The
// split pass took the raw brands, so the brand's norm is applied here,
// taken from an input of the call before the wait; an all-zero brand or
// post row gives NaN, as the plain version does.
__global__ void __launch_bounds__(NORM_THREADS) cosine_finish_kernel(
    const float* __restrict__ brands, const float* __restrict__ dots,
    const float* __restrict__ sqs, float* __restrict__ out, int B, int N,
    int D, int S) {
  const int n = blockIdx.x * NORM_THREADS + threadIdx.x;
  const size_t b = blockIdx.y;
  // the brand's norm, its sum of squares in a fixed order
  __shared__ float warp_sums[NORM_THREADS / 32];
  float bss = 0.0f;
  for (int d = threadIdx.x; d < D; d += NORM_THREADS)
    bss += brands[b * D + d] * brands[b * D + d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bss += __shfl_xor_sync(0xffffffffu, bss, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = bss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < NORM_THREADS / 32; ++w) total += warp_sums[w];
  const float nrm = sqrtf(total);
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the partials
  if (n >= N) return;
  float ss = 0.0f, dot = 0.0f;
#pragma unroll 8
  for (int z = 0; z < S; ++z) ss += sqs[(size_t)z * N + n];
#pragma unroll 8
  for (int z = 0; z < S; ++z) dot += dots[((size_t)z * B + b) * N + n];
  out[b * N + n] = dot / nrm * rsqrtf(ss);
}

}  // namespace

// brands (B, D) and posts (N, D) contiguous float32, out (B, N) float32;
// B, N >= 1. `slices` S splits D into S slices of whole stages of KC values
// (the caller's choice; ceil(stages / ceil(stages / S)) must equal S): S = 1
// is the single pass, on normalized brands, and takes no scratch; S > 1
// takes the raw brands and float32 scratch of dots (S, B, N), then sqs
// (S, N). Returns cudaGetLastError() after the launches (0 on success).
// Launches on `stream`, does not synchronise.
extern "C" int cosine_scores_fwd(const void* brands, const void* posts,
                                 void* out, void* scratch, int B, int N,
                                 int D, int slices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stages = (D + KC - 1) / KC;
  if (slices < 1 || slices > stages)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* br = static_cast<const float*>(brands);
  const float* p = static_cast<const float*>(posts);
  float* o = static_cast<float*>(out);
  if (slices == 1) {
    const dim3 grid((N + TN - 1) / TN, (B + TB - 1) / TB);
    cosine_scores_kernel<false><<<grid, THREADS, 0, s>>>(
        br, p, o, nullptr, nullptr, B, N, D, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const int per = (stages + slices - 1) / slices;      // stages a slice
  if ((stages + per - 1) / per != slices)
    return static_cast<int>(cudaErrorInvalidValue);
  float* d = static_cast<float*>(scratch);
  float* q = d + (size_t)slices * B * N;
  const dim3 grid((N + TN - 1) / TN, (B + TB - 1) / TB, slices);
  cosine_scores_kernel<true><<<grid, THREADS, 0, s>>>(br, p, nullptr, d, q, B,
                                                      N, D, per * KC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + NORM_THREADS - 1) / NORM_THREADS, B);
  cfg.blockDim = dim3(NORM_THREADS);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* dc = d;
  const float* qc = q;
  err = cudaLaunchKernelEx(&cfg, cosine_finish_kernel, br, dc, qc, o, B, N,
                           D, slices);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

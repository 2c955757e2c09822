// Fused int8 score + top-k -- the JAX package's Pallas kernel
// `retrieval_topk_fused_int8` (fancyrec_tpu/ops/similarity.py,
// `_topk_fused_kernel`).
//
//   qb   (B, D) int8    brands, quantized per row by the caller
//   qp   (N, D) int8    posts, quantized per row
//   inv  (N,)  float32  1 / ||qp_j||
//   ->   vals (B, k) float32, idx (B, k) int32, best first
//
// score[b, j] = float(int32 dot(qb[b], qp[j])) * inv[j] for j < n_valid.
// Selection orders by (score descending, index ascending), which is
// lax.top_k's tie rule. Slots past the n_valid candidates are filler:
// value -inf, index 0. The caller applies the brand scale afterwards.
//
// Design. The TPU kernel streams post blocks through a sequential grid and
// carries a running (B, 128) top-k in scratch. Hopper blocks run in no
// order, so this is two passes:
//   1. `topk_partial_kernel`: a block holds a tile of 64 quantized brands
//      in shared memory for its whole life and takes every gridDim.x-th
//      tile of 64 posts, streamed through shared memory 128 bytes of D at
//      a time (the next slice's loads in flight during the current one's
//      products). Exact int32 dot products come from the int8 tensor cores
//      (mma.sync m16n8k32): each warp owns 16 brands x 32 posts. The block
//      keeps a sorted top-k list per brand in shared memory; a tile's
//      scores reach the list only where they beat its current k-th entry,
//      so after the first tiles almost nothing is inserted. Each block
//      writes its lists: (B, gridDim.x, k) candidates.
//   2. `topk_merge_kernel`: one block per brand selects the k best of the
//      candidates, k rounds of a block-wide max.
// A candidate is one 64-bit key, (order-preserving bits of the score) << 32
// | (~index): a larger key is a larger score, or the same score at a
// smaller index. Keys are unique per post, so both passes need no
// tie-breaking of their own, and key 0 is the filler below every post.
//
// Bound on an H100 at the serving shape (B=51, N=1,000,000, D=1024, k=10):
// reading the 1.02 GB int8 index once takes 0.31 ms at 3.35 TB/s; the
// 104 G integer operations take 0.05 ms at the int8 tensor-core rate. So it
// is bytes-bound: the products are cheap on the tensor cores, and what
// remains is streaming the index, the scalar epilogue and the list merge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 64;          // brands per block: four m16 tiles
constexpr int TP = 64;          // posts per tile: eight n8 tiles
constexpr int KSW = 32;         // int32 words of D per post stage (128 bytes)
constexpr int PSW = KSW + 4;    // padded post row in shared memory, words
constexpr int THREADS = 256;    // 8 warps: one m16 tile x four n8 tiles each
constexpr int WARPS = THREADS / 32;
constexpr int PLD = TP * KSW / THREADS;   // post words a thread stages

typedef unsigned long long u64;

__device__ __forceinline__ u64 make_key(float s, int idx) {
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<u64>(~static_cast<unsigned>(idx));
}

__device__ __forceinline__ float key_score(u64 key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(u64 key) {
  return static_cast<int>(~static_cast<unsigned>(key & 0xffffffffu));
}

// brand row in shared memory, words: whole post stages plus 4 words of
// padding, so rows stay 16-byte aligned and a warp's fragment loads fall
// in 32 distinct banks
__host__ __device__ constexpr int brand_row_words(int D) {
  return (D / 4 + KSW - 1) / KSW * KSW + 4;
}

// dynamic shared memory of the partial kernel
__host__ __device__ constexpr size_t partial_smem(int D, int k) {
  return sizeof(int) * TB * brand_row_words(D) + sizeof(int) * TP * PSW +
         sizeof(float) * TB * (TP + 1) + sizeof(u64) * TB * k;
}

// D (16 x 8, s32) += A (16 x 32, s8, row) * B (32 x 8, s8, col), exact
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load_posts(const int8_t* __restrict__ qp,
                                           int p0, int w0, int dw,
                                           int n_valid, int D,
                                           int (&pr)[PLD]) {
#pragma unroll
  for (int q = 0; q < PLD; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int p = p0 + e / KSW, w = w0 + e % KSW;
    pr[q] = (p < n_valid && w < dw)
                ? reinterpret_cast<const int*>(qp + (size_t)p * D)[w] : 0;
  }
}

__global__ void __launch_bounds__(THREADS) topk_partial_kernel(
    const int8_t* __restrict__ qb, const int8_t* __restrict__ qp,
    const float* __restrict__ inv, u64* __restrict__ cand, int B, int D,
    int n_valid, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bsw = brand_row_words(D);
  int* bs = reinterpret_cast<int*>(smem);                    // [TB][bsw]
  int* ps = bs + TB * bsw;                                   // [TP][PSW]
  float* sc = reinterpret_cast<float*>(ps + TP * PSW);       // [TB][TP+1]
  u64* lists = reinterpret_cast<u64*>(sc + TB * (TP + 1));   // [TB][k]

  const int b0 = blockIdx.y * TB;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;     // mma fragment coordinates
  const int m0 = (warp % 4) * 16;           // this warp's brand rows
  const int n0 = (warp / 4) * 32;           // and its 32 posts of a tile
  const int dw = D / 4;                     // int32 words per row

  // the block's brands stay in shared memory for all of its tiles
  for (int e = threadIdx.x; e < TB * bsw; e += THREADS) {
    const int r = e / bsw, w = e % bsw;
    bs[e] = (b0 + r < B && w < dw)
        ? reinterpret_cast<const int*>(qb + (size_t)(b0 + r) * D)[w] : 0;
  }
  for (int e = threadIdx.x; e < TB * k; e += THREADS) lists[e] = 0ull;

  const int n_tiles = (n_valid + TP - 1) / TP;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * TP;
    int acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0;

    int pr[PLD];
    load_posts(qp, p0, 0, dw, n_valid, D, pr);
    for (int w0 = 0; w0 < dw; w0 += KSW) {
#pragma unroll
      for (int q = 0; q < PLD; ++q) {
        const int e = threadIdx.x + q * THREADS;
        ps[(e / KSW) * PSW + e % KSW] = pr[q];
      }
      __syncthreads();
      // the next stage's loads are in flight during these products
      if (w0 + KSW < dw) load_posts(qp, p0, w0 + KSW, dw, n_valid, D, pr);
#pragma unroll
      for (int ks = 0; ks < KSW; ks += 8) {   // 32 bytes of D per mma
        const int* arow = bs + (m0 + g) * bsw + w0 + ks + t;
        const int a0 = arow[0], a1 = arow[8 * bsw];
        const int a2 = arow[4], a3 = arow[8 * bsw + 4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int* brow = ps + (n0 + 8 * j + g) * PSW + ks + t;
          mma_s8(acc[j], a0, a1, a2, a3, brow[0], brow[4]);
        }
      }
      __syncthreads();
    }

    // scores: acc[j] holds rows m0+g, m0+g+8 x posts n0+8j+2t, +1
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = m0 + g + 8 * (c / 2);
        const int col = n0 + 8 * j + 2 * t + c % 2;
        const int p = p0 + col;
        sc[r * (TP + 1) + col] =
            p < n_valid ? static_cast<float>(acc[j][c]) * inv[p] : 0.0f;
      }
    __syncthreads();

    // merge this tile into the per-brand lists: one warp per brand row
    for (int r = warp; r < TB; r += WARPS) {
      if (b0 + r >= B) break;
      u64* list = lists + (size_t)r * k;
      u64 thr = list[k - 1];
#pragma unroll
      for (int h = 0; h < TP / 32; ++h) {
        const int p = p0 + lane + 32 * h;
        const u64 key =
            p < n_valid ? make_key(sc[r * (TP + 1) + lane + 32 * h], p) : 0ull;
        unsigned m = __ballot_sync(0xffffffffu, key > thr);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const u64 kk = __shfl_sync(0xffffffffu, key, src);
          if (kk > thr) {            // the threshold may have risen
            if (lane == 0) {
              int pos = k - 1;
              while (pos > 0 && list[pos - 1] < kk) {
                list[pos] = list[pos - 1];
                --pos;
              }
              list[pos] = kk;
            }
            __syncwarp();
            thr = list[k - 1];
            __syncwarp();            // every lane has read before lane 0 writes
          }
        }
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < TB * k; e += THREADS) {
    const int r = e / k, s = e % k;
    if (b0 + r < B)
      cand[((size_t)(b0 + r) * gridDim.x + blockIdx.x) * k + s] = lists[e];
  }
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS) topk_merge_kernel(
    const u64* __restrict__ cand, float* __restrict__ vals,
    int* __restrict__ idx, int n_cand, int k) {
  __shared__ u64 part[WARPS];
  __shared__ u64 best;
  const int b = blockIdx.x;
  const u64* c = cand + (size_t)b * n_cand;
  u64 last = ~0ull;                     // keys are unique: take the next below
  for (int s = 0; s < k; ++s) {
    u64 m = 0ull;
    for (int e = threadIdx.x; e < n_cand; e += THREADS) {
      const u64 v = c[e];
      if (v < last && v > m) m = v;
    }
    m = warp_max(m);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      u64 v = threadIdx.x < WARPS ? part[threadIdx.x] : 0ull;
      v = warp_max(v);
      if (threadIdx.x == 0) best = v;
    }
    __syncthreads();
    const u64 key = best;
    if (threadIdx.x == 0) {           // filler: -inf at index 0
      vals[(size_t)b * k + s] = key ? key_score(key) : __uint_as_float(0xff800000u);
      idx[(size_t)b * k + s] = key ? key_index(key) : 0;
    }
    last = key ? key : 1ull;            // after the filler only filler is left
    __syncthreads();
  }
}

}  // namespace

// D must be a multiple of 4 and every row 4-byte aligned; 1 <= k <= 128;
// the 64 brand rows must fit in shared memory beside the rest (D <= 2048
// on an H100; larger D fails at cudaFuncSetAttribute and is reported);
// cand holds B * grid * k 64-bit keys. Returns cudaGetLastError() after
// both launches (0 on success). Launches on `stream`, does not synchronise.
extern "C" int topk_int8_fwd(const void* qb, const void* qp, const void* inv,
                             void* cand, void* vals, void* idx, int B, int D,
                             int n_valid, int k, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem(D, k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g1(grid, (B + TB - 1) / TB);
  topk_partial_kernel<<<g1, THREADS, smem, s>>>(
      static_cast<const int8_t*>(qb), static_cast<const int8_t*>(qp),
      static_cast<const float*>(inv), static_cast<u64*>(cand), B, D, n_valid,
      k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<B, THREADS, 0, s>>>(
      static_cast<const u64*>(cand), static_cast<float*>(vals),
      static_cast<int*>(idx), grid * k, k);
  return static_cast<int>(cudaGetLastError());
}

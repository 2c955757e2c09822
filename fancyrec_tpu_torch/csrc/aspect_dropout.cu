// Fused brand-aspect dropout + mean, forward and backward -- the JAX
// package's Pallas kernels `aspect_dropout_mean` (`_fwd_impl` /
// `_fwd_kernel`) and `_adm_bwd` (`_bwd_kernel`) in
// fancyrec_tpu/ops/brand_pallas.py.
//
//   out[b, c]  = s * sum_a m[b, a, c] w[b, a] asp[a, c]
//   dw[b, a]   = s * sum_c m[b, a, c] g[b, c] asp[a, c]
//   dasp[a, c] = s * sum_b m[b, a, c] g[b, c] w[b, a]
//
// with s = 1 / (A keep) and the keep mask m = (bits <= thr), thr =
// min(int(keep 2^32) - 1, 2^32 - 1), so keep = 1 keeps every element.
// w (B, A), asp (A, C), g and out (B, C), all float32.
//
// Random bits. The TPU kernel draws from the TPU's hardware generator,
// which has no counterpart here. The bits are Philox4x32-10 (Salmon et al.,
// SC'11; Random123's constants), keyed by the two seed words. Element
// (b, a, c) takes word e & 3 of the Philox block at counter e >> 2, where
// e = (b A + a) C + c: a pure function of the element, not of the launch
// geometry, so the backward replays the forward's mask whatever the two
// grids are, and neither the (B, A, C) product nor the mask is ever stored.
// The mask follows the batch row b, not the brand id.
//
// Forward design. A block owns one row b and 64 columns: 16 threads of 4
// consecutive columns (one Philox call draws their 4 words) times 16
// aspect slices, each thread summing its slice of A in order; the 16
// partial sums of each output are added in a fixed order through shared
// memory.
// Backward design. A block owns 16 aspects and all C (in chunks of 1024
// columns, 4 a thread): it holds its asp tile and the dasp sums in
// registers, loops over the B rows replaying the mask, adds each row's
// dasp terms in registers and reduces the row's dw terms over the columns
// through warp shuffles and shared memory, in a fixed order. No atomics
// anywhere: results are the same run to run.
//
// Bound on an H100 at the training shape (B = 8, A = 2000, C = 1024): each
// pass draws 16.4M mask bits, 4.1M Philox4x32-10 blocks of 10 rounds (2
// 32-bit multiplies, a high and a low half each, and 4 other integer
// operations a round), plus 2 B A C = 33 MFLOP of float32 products. Its
// bytes are asp (8.2 MB) in, and dasp (8.2 MB) out in the backward. The
// bytes take 2.4 (forward) and 4.9 (backward) microseconds at 3.35 TB/s;
// the integer work of the generator is what bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t word_at(uint64_t e, uint2 key) {
  const uint64_t q = e >> 2;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32), 0u,
                 0u),
      key);
  switch (e & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// Keep bits of elements e0 .. e0+3 (bit i for e0 + i). With C % 4 == 0 and
// e0 % 4 == 0 one Philox block holds all four words.
__device__ __forceinline__ unsigned keep4(uint64_t e0, uint2 key,
                                          uint32_t thr, bool aligned) {
  uint32_t v0, v1, v2, v3;
  if (aligned) {
    const uint64_t q = e0 >> 2;
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                   0u, 0u),
        key);
    v0 = r.x; v1 = r.y; v2 = r.z; v3 = r.w;
  } else {
    v0 = word_at(e0, key);
    v1 = word_at(e0 + 1, key);
    v2 = word_at(e0 + 2, key);
    v3 = word_at(e0 + 3, key);
  }
  return (v0 <= thr) | ((v1 <= thr) << 1) | ((v2 <= thr) << 2) |
         ((v3 <= thr) << 3);
}

// 4 consecutive floats of a row from column c0, zero past C.
__device__ __forceinline__ void load4(const float* __restrict__ row, int c0,
                                      int C, bool aligned, float (&v)[4]) {
  if (aligned && c0 + 3 < C) {
    const float4 q = *reinterpret_cast<const float4*>(row + c0);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = c0 + i < C ? row[c0 + i] : 0.0f;
  }
}

constexpr int F_GROUPS = 16;                    // 4-column groups a block
constexpr int F_SLICES = 16;                    // aspect slices a block
constexpr int F_THREADS = F_GROUPS * F_SLICES;  // 256

// grid (ceil(C / (4 F_GROUPS)), B)
__global__ void __launch_bounds__(F_THREADS) adm_fwd_kernel(
    const float* __restrict__ w, const float* __restrict__ asp,
    float* __restrict__ out, int A, int C, uint2 key, uint32_t thr,
    float scale) {
  __shared__ float part[F_SLICES][F_GROUPS][4];
  const int grp = threadIdx.x % F_GROUPS, slice = threadIdx.x / F_GROUPS;
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x * F_GROUPS + grp) * 4;
  const bool aligned = (C & 3) == 0;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c0 < C) {
    for (int a = slice; a < A; a += F_SLICES) {
      const float wv = w[(size_t)b * A + a];
      const unsigned m =
          keep4(((uint64_t)b * A + a) * C + c0, key, thr, aligned);
      float av[4];
      load4(asp + (size_t)a * C, c0, C, aligned, av);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m & (1u << i)) acc[i] += wv * av[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) part[slice][grp][i] = acc[i];
  __syncthreads();
  if (slice != 0 || c0 >= C) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.0f;
    for (int p = 0; p < F_SLICES; ++p) s += part[p][grp][i];
    if (c0 + i < C) out[(size_t)b * C + c0 + i] = s * scale;
  }
}

constexpr int B_ASP = 16;                       // aspects a block
constexpr int B_THREADS = 256;                  // 4 columns each: 1024 a chunk
constexpr int B_WARPS = B_THREADS / 32;

// grid (ceil(A / B_ASP))
__global__ void __launch_bounds__(B_THREADS, 1) adm_bwd_kernel(
    const float* __restrict__ w, const float* __restrict__ asp,
    const float* __restrict__ g, float* __restrict__ dw,
    float* __restrict__ dasp, int B, int A, int C, uint2 key, uint32_t thr,
    float scale) {
  __shared__ float wpart[B_WARPS][B_ASP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a0 = blockIdx.x * B_ASP;
  const bool aligned = (C & 3) == 0;

  for (int cbase = 0; cbase < C; cbase += 4 * B_THREADS) {
    const int c0 = cbase + 4 * threadIdx.x;
    float av[B_ASP][4], dacc[B_ASP][4];
#pragma unroll
    for (int i = 0; i < B_ASP; ++i) {
      if (a0 + i < A) {
        load4(asp + (size_t)(a0 + i) * C, c0, C, aligned, av[i]);
      } else {
        av[i][0] = av[i][1] = av[i][2] = av[i][3] = 0.0f;
      }
      dacc[i][0] = dacc[i][1] = dacc[i][2] = dacc[i][3] = 0.0f;
    }
    for (int b = 0; b < B; ++b) {
      float gv[4];
      load4(g + (size_t)b * C, c0, C, aligned, gv);
      float dwp[B_ASP];
#pragma unroll
      for (int i = 0; i < B_ASP; ++i) {
        const int a = a0 + i;
        dwp[i] = 0.0f;
        if (a >= A || c0 >= C) continue;
        const float wv = w[(size_t)b * A + a];
        const unsigned m =
            keep4(((uint64_t)b * A + a) * C + c0, key, thr, aligned);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float mg = (m & (1u << q)) ? gv[q] : 0.0f;
          dacc[i][q] += mg * wv;
          dwp[i] += mg * av[i][q];
        }
      }
      // dw[b, a0 + i]: sum dwp[i] over the block's threads, in a fixed order
#pragma unroll
      for (int i = 0; i < B_ASP; ++i)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dwp[i] += __shfl_xor_sync(0xffffffffu, dwp[i], off);
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < B_ASP; ++i) wpart[warp][i] = dwp[i];
      __syncthreads();
      if (threadIdx.x < B_ASP && a0 + threadIdx.x < A) {
        float s = 0.0f;
        for (int p = 0; p < B_WARPS; ++p) s += wpart[p][threadIdx.x];
        float* dp = dw + (size_t)b * A + a0 + threadIdx.x;
        *dp = cbase == 0 ? s : *dp + s;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < B_ASP; ++i) {
      if (a0 + i >= A) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + q < C) dasp[(size_t)(a0 + i) * C + c0 + q] = dacc[i][q] * scale;
    }
  }
  // the same thread wrote each of these dw entries above
  if (threadIdx.x < B_ASP && a0 + threadIdx.x < A)
    for (int b = 0; b < B; ++b) dw[(size_t)b * A + a0 + threadIdx.x] *= scale;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); launches on
// `stream`, does not synchronise. seed0, seed1: the two key words.
extern "C" int aspect_dropout_fwd(const void* w, const void* asp, void* out,
                                  int B, int A, int C, unsigned seed0,
                                  unsigned seed1, unsigned thr, float scale,
                                  void* stream) {
  const dim3 grid((C + 4 * F_GROUPS - 1) / (4 * F_GROUPS), B);
  adm_fwd_kernel<<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(asp),
      static_cast<float*>(out), A, C, make_uint2(seed0, seed1), thr, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aspect_dropout_bwd(const void* w, const void* asp,
                                  const void* g, void* dw, void* dasp, int B,
                                  int A, int C, unsigned seed0, unsigned seed1,
                                  unsigned thr, float scale, void* stream) {
  const dim3 grid((A + B_ASP - 1) / B_ASP);
  adm_bwd_kernel<<<grid, B_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(asp),
      static_cast<const float*>(g), static_cast<float*>(dw),
      static_cast<float*>(dasp), B, A, C, make_uint2(seed0, seed1), thr,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// Bi-GRU recurrence, both directions, h0 = 0 -- the forward pass of the
// JAX package's Pallas kernel `gru_scan_pallas`
// (fancyrec_tpu/ops/gru_scan.py, `_fwd_impl` / `_fwd_kernel`), and below
// it the backward pass (`_gru_bwd` / `_bwd_kernel`).
//
//   xw   (T, 2, B, 3H)  input projections x W_ih^T + b_ih, float or bf16
//   w_hh (2, 3H, H)     recurrent weights, same type as xw
//   b_hh (2, 3H)        float32
//   out  (T, 2, B, H)   same type as xw
//
//   r  = sigmoid(x_r + h W_hr^T + b_hr)
//   z  = sigmoid(x_z + h W_hz^T + b_hz)
//   n  = tanh(x_n + r * (h W_hn^T + b_hn))
//   h' = (1 - z) n + z h
//
// Gate math and the dot products accumulate in float32; h is stored in the
// activation type, as the TPU kernel does.
//
// Design. The TPU kernel keeps h in VMEM across a sequential (batch, T)
// grid and all of W_hh resident; neither carries over to Hopper, whose
// blocks run in no order and whose 227 KB of shared memory cannot hold the
// 25.2 MB of float32 W_hh at H = 1024. Here the host launches one kernel
// per time step. Each block owns a tile of BM batch rows x BN hidden units
// of one direction, computes the three gate products h_{t-1} . W_hh[g*H+j]
// as a register-tiled SGEMM over H, applies the gates in the epilogue and
// writes h_t into `out`, from which the next step reads it. W_hh stays hot
// in the 50 MB L2 across the T launches. Each thread holds 8 rows x 2
// units x 3 gates, read per k as two float4 and three float2 shared loads
// (5 loads per 48 FMAs), and the next K-stage's global loads are held in
// registers while the current stage computes.
//
// Bound on an H100 at the serving shape (T=64, B=128, H=1024, float32):
// 2 * (T-1) * 2 * B * 3H * H = 101 GFLOP of float32 FMA work, no tensor
// cores (the port is float32 end to end and TF32 would change results),
// against 67 TFLOP/s: about 1.5 ms. The bytes (xw read once, out written
// once, W_hh once: 0.29 GB, 0.09 ms) do not bound it. So the kernel is
// operation-bound, and this simple version's limit is the issue rate of
// the FMA pipes and the shared-memory loads feeding them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // batch rows per block
constexpr int BN = 32;       // hidden units per block (each has 3 gates)
constexpr int BK = 16;       // depth of one shared-memory stage
constexpr int TM = 8;        // batch rows per thread (two float4 loads)
constexpr int TN = 2;        // hidden units per thread (a float2 per gate)
constexpr int TX = BN / TN;  // 16 threads along units
constexpr int THREADS = TX * (BM / TM);          // 128
constexpr int HLD = BM * BK / THREADS;           // h elements a thread stages
constexpr int WLD = 3 * BN * BK / THREADS;       // W_hh elements a thread stages
// padded rows: +4 keeps float4 alignment of the h tile, +2 keeps float2
// alignment of the W tile, and both spread the stores over the banks
constexpr int HS = BM + 4;
constexpr int WS = BN + 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One K-stage of h_{t-1} (BM x BK) and of the three gate row blocks of
// W_hh (3 x BN x BK) into registers; zero outside B, H.
template <typename T>
__device__ __forceinline__ void load_stage(const T* __restrict__ hprev,
                                           const T* __restrict__ w, int b0,
                                           int j0, int k0, int B, int H,
                                           float (&hr)[HLD],
                                           float (&wr)[WLD]) {
#pragma unroll
  for (int q = 0; q < HLD; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int b = b0 + e / BK, k = k0 + e % BK;
    hr[q] = (b < B && k < H) ? to_f(hprev[(size_t)b * H + k]) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < WLD; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int g = e / (BN * BK), rem = e % (BN * BK);
    const int j = j0 + rem / BK, k = k0 + rem % BK;
    wr[q] = (j < H && k < H) ? to_f(w[((size_t)g * H + j) * H + k]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gru_step_kernel(
    const T* __restrict__ xw, const T* __restrict__ w_hh,
    const float* __restrict__ b_hh, T* __restrict__ out, int t, int B,
    int H) {
  __shared__ __align__(16) float hs[BK][HS];       // h_{t-1}, k-major
  __shared__ __align__(16) float ws[3][BK][WS];    // gate rows, k-major

  const int d = blockIdx.z;              // direction
  const int b0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX;       // units j0 + tx*TN + n
  const int ty = threadIdx.x / TX;       // rows  b0 + ty*TM + i
  const size_t G = 3 * (size_t)H;

  float acc[3][TM][TN];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[g][i][n] = 0.0f;

  const T* hprev =
      t > 0 ? out + ((size_t)(t - 1) * 2 + d) * B * H : nullptr;
  if (t > 0) {                           // h0 = 0: step 0 has no product
    const T* w = w_hh + (size_t)d * G * H;
    float hr[HLD], wr[WLD];
    load_stage(hprev, w, b0, j0, 0, B, H, hr, wr);
    for (int k0 = 0; k0 < H; k0 += BK) {
#pragma unroll
      for (int q = 0; q < HLD; ++q) {
        const int e = threadIdx.x + q * THREADS;
        hs[e % BK][e / BK] = hr[q];
      }
#pragma unroll
      for (int q = 0; q < WLD; ++q) {
        const int e = threadIdx.x + q * THREADS;
        const int rem = e % (BN * BK);
        ws[e / (BN * BK)][rem % BK][rem / BK] = wr[q];
      }
      __syncthreads();
      // the next stage's global loads are in flight during these FMAs
      if (k0 + BK < H) load_stage(hprev, w, b0, j0, k0 + BK, B, H, hr, wr);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 h0 = *reinterpret_cast<const float4*>(&hs[kk][ty * TM]);
        const float4 h1 =
            *reinterpret_cast<const float4*>(&hs[kk][ty * TM + 4]);
        const float hv[TM] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float2 wv =
              *reinterpret_cast<const float2*>(&ws[g][kk][tx * TN]);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[g][i][0] = fmaf(hv[i], wv.x, acc[g][i][0]);
            acc[g][i][1] = fmaf(hv[i], wv.y, acc[g][i][1]);
          }
        }
      }
      __syncthreads();
    }
  }

  const T* x_t = xw + ((size_t)t * 2 + d) * B * G;
  T* out_t = out + ((size_t)t * 2 + d) * B * H;
  const float* bh = b_hh + (size_t)d * G;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int j = j0 + tx * TN + n;
      if (j >= H) continue;
      const T* x = x_t + (size_t)b * G;
      const float r = sigmoidf(to_f(x[j]) + (acc[0][i][n] + bh[j]));
      const float z = sigmoidf(to_f(x[H + j]) + (acc[1][i][n] + bh[H + j]));
      const float nn =
          tanhf(to_f(x[2 * H + j]) + r * (acc[2][i][n] + bh[2 * H + j]));
      const float hp = t > 0 ? to_f(hprev[(size_t)b * H + j]) : 0.0f;
      out_t[(size_t)b * H + j] = from_f<T>((1.0f - z) * nn + z * hp);
    }
  }
}

template <typename T>
int launch_all(const void* xw, const void* w_hh, const void* b_hh, void* out,
               int T_, int B, int H, cudaStream_t stream) {
  const dim3 grid((H + BN - 1) / BN, (B + BM - 1) / BM, 2);
  for (int t = 0; t < T_; ++t) {
    gru_step_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(xw), static_cast<const T*>(w_hh),
        static_cast<const float*>(b_hh), static_cast<T*>(out), t, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward: the reverse-time pass of `_gru_bwd` / `_bwd_kernel`
// (fancyrec_tpu/ops/gru_scan.py). For t = T-1 .. 0, with dh = dout_t +
// the carry from step t+1 (zero at T-1):
//
//   recompute r, z, npre = h_{t-1} W_hn^T + b_hn, n    from h_{t-1}
//   dn = dh (1-z)   dz = dh (h_{t-1} - n)   da_n = dn (1-n^2)
//   da_z = dz z (1-z)   dr = da_n npre   da_r = dr r (1-r)   da_np = da_n r
//   dxw_t = [da_r, da_z, da_n]     danp_t = da_np
//   carry = dh z + [da_r, da_z, da_np] W_hh          (the grad of h_{t-1})
//
// dW_hh and db_hh are formed outside, as in the JAX package.
//
// Design. The carry of step t needs a contraction over all 3H gate
// columns, and those come from every hidden unit's gate recompute, so no
// block that owns a slice of units can finish it alone. Each reverse step
// is therefore two launches (2T - 1 a call; the carry past t = 0 is not
// needed):
//   1. gate kernel: one warp per hidden unit j and one block per 8 batch
//      rows. The block stages h_{t-1} of its rows in shared memory; each
//      warp streams W_hh's three gate rows of unit j (contiguous in k,
//      coalesced), accumulates the 3 x 8 dot products over its lanes and
//      reduces them with a butterfly of shuffles, so every lane holds the
//      same sums. Lane b then does row b's gate math, writes dxw_t and
//      danp_t, leaves dh z in the carry buffer, and writes the gate grads
//      da_cat (rounded to the activation type, as the TPU kernel rounds
//      them) transposed, [3H][8 rows], for the contraction.
//   2. carry kernel: one block per 16 output units and 8 batch rows; its 16
//      half-warps split the 3H reduction rows, read W_hh[g, k0:k0+16] and
//      the 8 rows' da_cat[g] (one broadcast pair of float4 loads), and the
//      16 partial sums of each output are added in a fixed order through
//      shared memory. No atomics: a call's result is the same run to run.
// Bound on an H100 at the training shape (T=64, B=8, H=1024, float32): two
// B x 3H x H products per direction per step, 2 * 2 * 64 * 2 * 8 * 3072 *
// 1024 = 12.9 GFLOP, 0.19 ms at 67 TFLOP/s; its device-memory bytes (xw,
// h_prev, dout, dxw, danp, W_hh once: about 63 MB) take 0.02 ms. At B = 8
// each launch reads all of W_hh (25.2 MB, resident in the 50 MB L2) for 8
// rows of work, so the L2 stream of 2 x 25.2 MB a step, and the 127 launch
// gaps, are what this simple version's time is made of.

constexpr int BWD_ROWS = 8;                   // batch rows per block
constexpr int BWD_WARPS = 8;                  // hidden units per gate block
constexpr int BWD_THREADS = 32 * BWD_WARPS;   // 256
constexpr int CARRY_COLS = 16;                // output units per carry block
constexpr int CARRY_SLICES = 2 * BWD_WARPS;   // half-warps splitting 3H

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// grid (ceil(H / BWD_WARPS), ceil(B / BWD_ROWS), 2); dynamic shared memory
// BWD_ROWS * H floats. `carry` (2, B, H) float: in, the grad of h_t from
// step t+1 (read only when has_carry); out, dh z. `da` (2, ceil(B/8), 3H,
// 8) float: out, the gate grads of this step.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) gru_bwd_gate_kernel(
    const T* __restrict__ xw, const T* __restrict__ h_prev,
    const T* __restrict__ dout, const T* __restrict__ w_hh,
    const float* __restrict__ b_hh, T* __restrict__ dxw,
    T* __restrict__ danp, float* __restrict__ carry, float* __restrict__ da,
    int t, int B, int H, int has_carry) {
  extern __shared__ float hs[];                    // [BWD_ROWS][H]
  const int d = blockIdx.z;
  const int b0 = blockIdx.y * BWD_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * BWD_WARPS + warp;
  const size_t G = 3 * (size_t)H;
  const size_t step = (size_t)t * 2 + d;           // (t, d) slab index

  const T* hp = h_prev + step * B * H;
  for (int e = threadIdx.x; e < BWD_ROWS * H; e += BWD_THREADS) {
    const int b = b0 + e / H;
    hs[e] = b < B ? to_f(hp[(size_t)b * H + e % H]) : 0.0f;
  }
  __syncthreads();
  if (j >= H) return;                              // after the only barrier

  const T* w = w_hh + (size_t)d * G * H;
  const T* wr = w + (size_t)j * H;
  const T* wz = w + ((size_t)H + j) * H;
  const T* wn = w + ((size_t)2 * H + j) * H;
  float acc[3][BWD_ROWS];
#pragma unroll
  for (int i = 0; i < BWD_ROWS; ++i) acc[0][i] = acc[1][i] = acc[2][i] = 0.0f;
  for (int k = lane; k < H; k += 32) {
    const float vr = to_f(wr[k]), vz = to_f(wz[k]), vn = to_f(wn[k]);
#pragma unroll
    for (int i = 0; i < BWD_ROWS; ++i) {
      const float hv = hs[i * H + k];
      acc[0][i] = fmaf(hv, vr, acc[0][i]);
      acc[1][i] = fmaf(hv, vz, acc[1][i]);
      acc[2][i] = fmaf(hv, vn, acc[2][i]);
    }
  }
  // xor butterfly: partners add the same two numbers, so every lane ends
  // with bit-identical sums
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < BWD_ROWS; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
  if (lane >= BWD_ROWS) return;

  float pr = 0.0f, pz = 0.0f, pn = 0.0f;           // row `lane`'s products
#pragma unroll
  for (int i = 0; i < BWD_ROWS; ++i)
    if (lane == i) {
      pr = acc[0][i];
      pz = acc[1][i];
      pn = acc[2][i];
    }
  float* da_rows = da + ((size_t)d * gridDim.y + blockIdx.y) * G * BWD_ROWS;
  const int b = b0 + lane;
  if (b >= B) {                      // rows past B feed no stored output
    da_rows[(size_t)j * BWD_ROWS + lane] = 0.0f;
    da_rows[((size_t)H + j) * BWD_ROWS + lane] = 0.0f;
    da_rows[((size_t)2 * H + j) * BWD_ROWS + lane] = 0.0f;
    return;
  }
  const T* x = xw + (step * B + b) * G;
  const float* bh = b_hh + (size_t)d * G;
  const float r = sigmoidf(to_f(x[j]) + (pr + bh[j]));
  const float z = sigmoidf(to_f(x[H + j]) + (pz + bh[H + j]));
  const float npre = pn + bh[2 * H + j];
  const float n = tanhf(to_f(x[2 * H + j]) + r * npre);
  const float h = hs[lane * H + j];
  const size_t o = (step * B + b) * H + j;
  const size_t c = ((size_t)d * B + b) * H + j;
  const float dh = to_f(dout[o]) + (has_carry ? carry[c] : 0.0f);
  const float dn = dh * (1.0f - z);
  const float dz = dh * (h - n);
  const float da_n = dn * (1.0f - n * n);
  const float da_z = dz * z * (1.0f - z);
  const float dr = da_n * npre;
  const float da_r = dr * r * (1.0f - r);
  const float da_np = da_n * r;
  T* dx = dxw + (step * B + b) * G;
  dx[j] = from_f<T>(da_r);
  dx[H + j] = from_f<T>(da_z);
  dx[2 * H + j] = from_f<T>(da_n);
  danp[o] = from_f<T>(da_np);
  da_rows[(size_t)j * BWD_ROWS + lane] = round_to<T>(da_r);
  da_rows[((size_t)H + j) * BWD_ROWS + lane] = round_to<T>(da_z);
  da_rows[((size_t)2 * H + j) * BWD_ROWS + lane] = round_to<T>(da_np);
  carry[c] = dh * z;                 // the carry kernel adds da_cat W_hh
}

// grid (ceil(H / CARRY_COLS), ceil(B / BWD_ROWS), 2):
// carry[d, b, k] = round(carry[d, b, k] + sum_g da[d, b, g] W_hh[d, g, k]).
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) gru_bwd_carry_kernel(
    const T* __restrict__ w_hh, const float* __restrict__ da,
    float* __restrict__ carry, int B, int H) {
  __shared__ float part[CARRY_SLICES][BWD_ROWS][CARRY_COLS];
  const int d = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slice = warp * 2 + lane / CARRY_COLS;
  const int col = lane % CARRY_COLS;
  const int k = blockIdx.x * CARRY_COLS + col;
  const int G = 3 * H;
  const T* w = w_hh + (size_t)d * G * H;
  const float* da_rows =
      da + ((size_t)d * gridDim.y + blockIdx.y) * (size_t)G * BWD_ROWS;

  float acc[BWD_ROWS];
#pragma unroll
  for (int i = 0; i < BWD_ROWS; ++i) acc[i] = 0.0f;
  if (k < H) {
    for (int g = slice; g < G; g += CARRY_SLICES) {
      const float wv = to_f(w[(size_t)g * H + k]);
      const float4 a0 =
          *reinterpret_cast<const float4*>(da_rows + (size_t)g * BWD_ROWS);
      const float4 a1 =
          *reinterpret_cast<const float4*>(da_rows + (size_t)g * BWD_ROWS + 4);
      acc[0] = fmaf(a0.x, wv, acc[0]);
      acc[1] = fmaf(a0.y, wv, acc[1]);
      acc[2] = fmaf(a0.z, wv, acc[2]);
      acc[3] = fmaf(a0.w, wv, acc[3]);
      acc[4] = fmaf(a1.x, wv, acc[4]);
      acc[5] = fmaf(a1.y, wv, acc[5]);
      acc[6] = fmaf(a1.z, wv, acc[6]);
      acc[7] = fmaf(a1.w, wv, acc[7]);
    }
  }
#pragma unroll
  for (int i = 0; i < BWD_ROWS; ++i) part[slice][i][col] = acc[i];
  __syncthreads();
  if (threadIdx.x >= BWD_ROWS * CARRY_COLS) return;
  const int i = threadIdx.x / CARRY_COLS, c2 = threadIdx.x % CARRY_COLS;
  const int b = blockIdx.y * BWD_ROWS + i;
  const int kk = blockIdx.x * CARRY_COLS + c2;
  if (b >= B || kk >= H) return;
  float s = 0.0f;
#pragma unroll
  for (int p = 0; p < CARRY_SLICES; ++p) s += part[p][i][c2];
  float* cp = carry + ((size_t)d * B + b) * H + kk;
  *cp = round_to<T>(*cp + s);
}

template <typename T>
int launch_bwd(const void* xw, const void* h_prev, const void* dout,
               const void* w_hh, const void* b_hh, void* dxw, void* danp,
               void* carry, void* da, int T_, int B, int H,
               cudaStream_t stream) {
  const int groups = (B + BWD_ROWS - 1) / BWD_ROWS;
  const dim3 gate_grid((H + BWD_WARPS - 1) / BWD_WARPS, groups, 2);
  const dim3 carry_grid((H + CARRY_COLS - 1) / CARRY_COLS, groups, 2);
  const size_t smem = sizeof(float) * BWD_ROWS * (size_t)H;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_gate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int t = T_ - 1; t >= 0; --t) {
    gru_bwd_gate_kernel<T><<<gate_grid, BWD_THREADS, smem, stream>>>(
        static_cast<const T*>(xw), static_cast<const T*>(h_prev),
        static_cast<const T*>(dout), static_cast<const T*>(w_hh),
        static_cast<const float*>(b_hh), static_cast<T*>(dxw),
        static_cast<T*>(danp), static_cast<float*>(carry),
        static_cast<float*>(da), t, B, H, t < T_ - 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (t == 0) break;                 // the grad of h0 is not needed
    gru_bwd_carry_kernel<T><<<carry_grid, BWD_THREADS, 0, stream>>>(
        static_cast<const T*>(w_hh), static_cast<const float*>(da),
        static_cast<float*>(carry), B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// T launches (0 on success). Launches on `stream`, does not synchronise.
extern "C" int gru_scan_fwd(const void* xw, const void* w_hh,
                            const void* b_hh, void* out, int T_, int B, int H,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_all<float>(xw, w_hh, b_hh, out, T_, B, H, s);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(xw, w_hh, b_hh, out, T_, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward pass (2T - 1 launches). xw, dout, h_prev (T, 2, B, 3H|H|H),
// w_hh (2, 3H, H) in the activation type, b_hh (2, 3H) float32; outputs
// dxw (T, 2, B, 3H) and danp (T, 2, B, H) in the activation type. Scratch,
// allocated by the caller: carry (2, B, H) and da (2, ceil(B/8), 3H, 8),
// both float32. dtype and the return value as for gru_scan_fwd.
extern "C" int gru_scan_bwd(const void* xw, const void* h_prev,
                            const void* dout, const void* w_hh,
                            const void* b_hh, void* dxw, void* danp,
                            void* carry, void* da, int T_, int B, int H,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(xw, h_prev, dout, w_hh, b_hh, dxw, danp, carry,
                             da, T_, B, H, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(xw, h_prev, dout, w_hh, b_hh, dxw, danp,
                                     carry, da, T_, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bi-GRU recurrence, both directions, h0 = 0 -- the forward pass of the
// JAX package's Pallas kernel `gru_scan_pallas`
// (fancyrec_tpu/ops/gru_scan.py, `_fwd_impl` / `_fwd_kernel`).
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

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
// Forward design. The TPU kernel keeps h in VMEM across a sequential
// (batch, T) grid with all of W_hh resident; neither carries over to
// Hopper, whose blocks run in no order and whose 227 KB of shared memory
// cannot hold the 25.2 MB of float32 W_hh at H = 1024. The host launches
// one kernel per time step; step 0 forms no product (h0 = 0). A block owns
// R batch rows of one direction (R = 8, 16 or 32, picked from B) and a
// span of hidden units. It stages h_{t-1} of its R rows in shared memory
// once, as float: R x H x 4 bytes, 32-128 KB at H = 1024. Each of its 8
// warps takes one hidden unit j at a time: its lanes
// walk k with 16-byte loads of W_hh's three gate rows of j (512 B a warp
// instruction, coalesced) and 16-byte shared loads of the R rows of h
// (conflict-free), into 3 x R float32 sums a lane. A reduce-scatter of
// shuffles in a fixed order leaves row i's three sums in lane group i
// (31 shuffles for 32 sums, against 160 for a full butterfly), whose first
// lane applies the gates and writes out[t, d, b0 + i, j]; it loads that
// row's x and b_hh values for j as the unit starts, so their latency hides
// behind the products. No atomics: a call gives the same bits run to run.
//
// What limited the register-tiled SGEMM this replaces was latency: at
// B = 8, 64 blocks of 4 warps (fewer than half the SMs, one warp a
// scheduler), 64 K-stages each with two barriers and one stage of loads in
// flight, and a 64-row tile of which 56 rows were zeros; its time a step
// hardly moved from B = 8 to B = 128. Here every SM has work at B = 8 (256
// blocks of 8 warps at H = 1024), a block meets one barrier a step, and the
// loads of W_hh for the next stage (also across the end of one unit and
// the start of the next) are in flight in registers while the current
// stage is multiplied; the first are issued before h is staged. Steps
// 1.. are launched with programmatic dependent launch: a step's blocks
// start as the previous step's last blocks run, issue their W_hh loads,
// and wait (griddepcontrol.wait) only before they read h.
//
// Bound on an H100 (float32 FMA at 67 TFLOP/s; no tensor cores, since the
// port is float32 end to end and TF32 would change results): 2 * (T-1) * 2
// * B * 3H * H operations, 101 GFLOP or 1.514 ms at T = 64, B = 128,
// H = 1024 (serving, evaluation), 6.3 GFLOP or 0.095 ms at B = 8
// (training). The device-memory bytes (xw and out once, W_hh once) take
// 0.09 ms and 0.01 ms. Within a step W_hh stays in the 50 MB L2, and each
// row group of a direction reads its half once: 25.2 MB x ceil(B / R) of
// L2 reads a step (25.2 MB at B = 8, R = 8; 101 MB at B = 128, R = 32),
// plus h staged once a block. At B = 8 a step is that L2 stream; at
// B = 128 the FMA pipes and the shared-memory loads feeding them (one
// 16-byte load per 12 FMAs a lane).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

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

constexpr int FWD_WARPS = 8;                  // warps of a forward block
constexpr int FWD_THREADS = 32 * FWD_WARPS;   // 256
constexpr int FWD_DEPTH = 2;                  // vectors a lane loads per gate
                                              // row and stage

// N consecutive values of T in one load: 16 bytes on the vector path, one
// value where W_hh's rows are not 16-byte aligned (H % N != 0)
template <typename T, int N> struct Vec;
template <> struct Vec<float, 4> { using raw = float4; };
template <> struct Vec<__nv_bfloat16, 8> { using raw = uint4; };
template <typename T> struct Vec<T, 1> { using raw = T; };

__device__ __forceinline__ void unpack(const float4& r, float (&f)[4]) {
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}
// eight bf16, low half of each word first; a bf16 is the top 16 bits of
// the float it widens to
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(float r, float (&f)[1]) { f[0] = r; }
__device__ __forceinline__ void unpack(__nv_bfloat16 r, float (&f)[1]) {
  f[0] = __bfloat162float(r);
}

template <int N>
__device__ __forceinline__ void load_h(const float* p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(p + 4 * q);
      f[4 * q] = a.x;
      f[4 * q + 1] = a.y;
      f[4 * q + 2] = a.z;
      f[4 * q + 3] = a.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_h(float* p, const float (&f)[N]) {
  if constexpr (N == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      *reinterpret_cast<float4*>(p + 4 * q) =
          make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
  }
}

// One reduce-scatter stage with HALF = R >> (s + 1) at stage s (offset
// 16 >> s): each lane hands the half of v[0, 2 HALF) that its offset bit
// does not select to the partner lane and adds the partner's copy of the
// half it keeps into v[0, HALF); then the next stage. Recursion, so that
// every index is a constant and v stays in registers.
template <int R, int HALF>
__device__ __forceinline__ void scatter_rows(float (&v)[R], int lane) {
  if constexpr (HALF >= 1) {
    constexpr int OFF = 32 * HALF / R;
    const bool up = lane & OFF;
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float send = up ? v[k] : v[k + HALF];
      const float keep = up ? v[k + HALF] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    scatter_rows<R, HALF / 2>(v, lane);
  }
}

// Sums each of the R values over the warp's lanes. Lane l returns the sum
// of v[l / (32 / R)]: log2 R reduce-scatter stages (offsets 16, 8, ...),
// then a butterfly over the lower offsets adds within each group of
// 32 / R lanes, whose members end with the same bits. Clobbers v.
template <int R>
__device__ __forceinline__ float reduce_rows(float (&v)[R], int lane) {
  scatter_rows<R, R / 2>(v, lane);
  float sum = v[0];
#pragma unroll
  for (int off = 16 / R; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// xv, bv = x_r, x_z, x_n of row b (x points at its xw row) and b_hr,
// b_hz, b_hn, for unit j
template <typename T>
__device__ __forceinline__ void load_gates(const T* x, const float* bh,
                                           int j, int H, float* xv,
                                           float* bv) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    xv[g] = to_f(x[g * H + j]);
    bv[g] = bh[g * H + j];
  }
}

// h' from the gate inputs, the three products h W_h*^T and h
__device__ __forceinline__ float gru_cell(const float* xv, const float* bv,
                                          float pr, float pz, float pn,
                                          float h) {
  const float r = sigmoidf(xv[0] + (pr + bv[0]));
  const float z = sigmoidf(xv[1] + (pz + bv[1]));
  const float nn = tanhf(xv[2] + r * (pn + bv[2]));
  return (1.0f - z) * nn + z * h;
}

// Programmatic dependent launch: step t + 1's blocks may start while step
// t's last blocks run; they load W_hh, then wait here for step t to end
// (and its writes to be visible) before reading h_t. Both are no-ops in a
// kernel launched without the attribute.
__device__ __forceinline__ void let_next_step_start() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_previous_step() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// grid (ceil(H / span), ceil(B / R), 2), FWD_THREADS threads, dynamic
// shared memory R * HP floats (HP = H rounded up to 4). A block takes units
// [blockIdx.x * span, + span) (span a multiple of FWD_WARPS); warp w takes
// unit w of each round of FWD_WARPS units. N values of a gate row a load
// (N divides H on the vector path).
template <typename T, int R, int N>
__global__ void __launch_bounds__(FWD_THREADS) gru_step_kernel_rows(
    const T* __restrict__ xw, const T* __restrict__ w_hh,
    const float* __restrict__ b_hh, T* __restrict__ out, int t, int B,
    int H, int span) {
  using Raw = typename Vec<T, N>::raw;
  constexpr int LANES = 32 / R;               // lanes that end with a row
  constexpr int CH = 32 * FWD_DEPTH;          // vectors of a row a stage
  extern __shared__ __align__(16) float hs[];  // [R][HP]: h_{t-1}, float
  const int HP = (H + 3) & ~3;
  const int d = blockIdx.z;
  const int b0 = blockIdx.y * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t G = 3 * (size_t)H;
  const size_t slab = (size_t)t * 2 + d;      // (t, d) slab index
  const int j0 = static_cast<int>(blockIdx.x) * span;
  const int j_end = min(H, j0 + span);
  const int rounds = j0 + warp < j_end
                         ? (j_end - j0 - warp + FWD_WARPS - 1) / FWD_WARPS
                         : 0;
  const int row = lane / LANES;
  const int b = b0 + row;
  const bool writes = lane % LANES == 0 && b < B;
  const T* x = xw + (slab * B + b) * G;       // read only where `writes`
  T* o = out + (slab * B + b) * H;
  const float* bh = b_hh + (size_t)d * G;
  float xv[3], bv[3];                         // a unit's gate inputs

  let_next_step_start();
  if (t == 0) {                               // h_{-1} = 0: no product
    wait_for_previous_step();
    if (writes)
      for (int q = 0; q < rounds; ++q) {
        const int j = j0 + q * FWD_WARPS + warp;
        load_gates(x, bh, j, H, xv, bv);
        o[j] = from_f<T>(gru_cell(xv, bv, 0.0f, 0.0f, 0.0f, 0.0f));
      }
    return;
  }

  const T* w = w_hh + (size_t)d * G * H;
  const int HV = H / N;                       // vectors a row of h or W_hh
  const int nch = (HV + CH - 1) / CH;         // stages a unit
  const int total = rounds * nch;             // stages of this warp

  // stage `it`'s W_hh vectors: round it / nch, vectors (it % nch) * CH + ..
  // (those past HV are left unset: the products skip them)
  auto fetch = [&](Raw(&buf)[FWD_DEPTH][3], int it) {
    const int q = it / nch, c = it - q * nch;
    const int j = j0 + q * FWD_WARPS + warp;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const T* wrow = w + ((size_t)g * H + j) * H;
#pragma unroll
      for (int s = 0; s < FWD_DEPTH; ++s) {
        const int v = (c * FWD_DEPTH + s) * 32 + lane;
        if (v < HV)
          buf[s][g] = *reinterpret_cast<const Raw*>(wrow + (size_t)v * N);
      }
    }
  };

  Raw cur[FWD_DEPTH][3], nxt[FWD_DEPTH][3];
  if (total > 0) fetch(cur, 0);               // in flight while h is staged
  wait_for_previous_step();
  // h_{t-1} = out[t - 1, d] of the block's rows, N values a load; rows past
  // B are zeros (columns past H are never read)
  const T* hp = out + (slab - 2) * B * H;
#pragma unroll 4
  for (int e = threadIdx.x; e < R * HV; e += FWD_THREADS) {
    const int i = e / HV, v = e - i * HV;
    float f[N];
    if (b0 + i < B) {
      unpack(*reinterpret_cast<const Raw*>(hp + (size_t)(b0 + i) * H +
                                           (size_t)v * N),
             f);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) f[n] = 0.0f;
    }
    store_h<N>(hs + i * HP + v * N, f);
  }
  __syncthreads();

  float acc[3][R];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[g][i] = 0.0f;

  for (int it = 0; it < total; ++it) {
    const int q = it / nch, c = it - q * nch;
    const int j = j0 + q * FWD_WARPS + warp;
    if (it + 1 < total) fetch(nxt, it + 1);
    if (c == 0 && writes) load_gates(x, bh, j, H, xv, bv);
#pragma unroll
    for (int s = 0; s < FWD_DEPTH; ++s) {
      const int v = (c * FWD_DEPTH + s) * 32 + lane;
      if (v < HV) {
        float wv[3][N];
#pragma unroll
        for (int g = 0; g < 3; ++g) unpack(cur[s][g], wv[g]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float hv[N];
          load_h<N>(hs + i * HP + v * N, hv);
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int n = 0; n < N; ++n)
              acc[g][i] = fmaf(hv[n], wv[g][n], acc[g][i]);
        }
      }
    }
    if (c == nch - 1) {                       // unit j is summed
      float sum[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        sum[g] = reduce_rows<R>(acc[g], lane);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[g][i] = 0.0f;
      }
      if (writes)
        o[j] = from_f<T>(gru_cell(xv, bv, sum[0], sum[1], sum[2],
                                  hs[row * HP + j]));
    }
#pragma unroll
    for (int s = 0; s < FWD_DEPTH; ++s)
#pragma unroll
      for (int g = 0; g < 3; ++g) cur[s][g] = nxt[s][g];
  }
}

// The T step launches with R rows a block, steps 1.. with programmatic
// dependent launch where `pdl`. A block takes enough rounds of units that
// all blocks are resident at once (one wave), which stages h the fewest
// times for the same rounds a warp.
template <typename T, int R, int N>
int launch_rows(const void* xw, const void* w_hh, const void* b_hh,
                void* out, int T_, int B, int H, bool pdl,
                cudaStream_t stream) {
  const auto kernel = gru_step_kernel_rows<T, R, N>;
  const size_t smem = sizeof(float) * R * (size_t)((H + 3) & ~3);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        FWD_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = (B + R - 1) / R;
  const long rounds = (H + FWD_WARPS - 1) / FWD_WARPS;   // of all H units
  const long slots = (long)sms * per_sm;
  const int span =
      static_cast<int>((rounds * groups * 2 + slots - 1) / slots) * FWD_WARPS;
  const dim3 grid((H + span - 1) / span, groups, 2);
  const T* x = static_cast<const T*>(xw);
  const T* w = static_cast<const T*>(w_hh);
  const float* bias = static_cast<const float*>(b_hh);
  T* o = static_cast<T*>(out);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FWD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  for (int t = 0; t < T_; ++t) {
    // step 0 waits for all earlier work on the stream, as xw's producer
    if (pdl && t > 0) {
      err = cudaLaunchKernelEx(&cfg, kernel, x, w, bias, o, t, B, H, span);
    } else {
      kernel<<<grid, FWD_THREADS, smem, stream>>>(x, w, bias, o, t, B, H,
                                                  span);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows 0 picks R from B and H; 8, 16 or 32 forces it.
template <typename T, int N>
int launch_fwd(const void* xw, const void* w_hh, const void* b_hh, void* out,
               int T_, int B, int H, int rows, bool pdl,
               cudaStream_t stream) {
  if (rows == 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the fewest rows that hold B, up to 32: W_hh is read ceil(B / R)
    // times a step, while a larger R leaves fewer warps an SM (at
    // H = 1024, 16 at R = 8, 8 at R = 32); PERF.md has the time of each
    rows = B <= 8 ? 8 : B <= 16 ? 16 : 32;
    // the staged rows must fit a block's shared memory (R = 8 holds H up
    // to 7,264; past that the launch is refused)
    while (rows > 8 && sizeof(float) * rows * (size_t)((H + 3) & ~3) >
                           static_cast<size_t>(optin))
      rows /= 2;
  }
  // 16-byte loads need 16-byte aligned rows
  const bool vec = H % N == 0 &&
                   reinterpret_cast<uintptr_t>(w_hh) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
#define FWD_LAUNCH(R, V)                                             \
  if (rows == R)                                                     \
  return launch_rows<T, R, V>(xw, w_hh, b_hh, out, T_, B, H, pdl, stream)
  if (vec) {
    FWD_LAUNCH(8, N);
    FWD_LAUNCH(16, N);
    FWD_LAUNCH(32, N);
  } else {
    FWD_LAUNCH(8, 1);
    FWD_LAUNCH(16, 1);
    FWD_LAUNCH(32, 1);
  }
#undef FWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
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
// needed), both streaming all of W_hh from L2 (25.2 MB at H = 1024):
//   1. gate kernel, `gru_bwd_gate_rows<T, R, N>`: the forward's block
//      shape. A block of 8 warps owns R batch rows (8, 16 or 32, from B) of
//      one direction and a span of hidden units; it stages h_{t-1} of its
//      rows in shared memory once, and each warp takes one unit j at a time,
//      streaming W_hh's three gate rows of j with 16-byte loads (the next
//      stage's in flight) into 3 x R float32 sums a lane, which a fixed-order
//      reduce-scatter (`reduce_rows`) leaves in one lane group a row. That
//      group's first lane adds the carry in (below), does row b's gate math,
//      writes dxw_t and danp_t, keeps dh z for the next carry, and writes
//      the gate grads da_cat (rounded to the activation type, as the TPU
//      kernel rounds them) as [3H][8 rows] for each group of 8 rows.
//   2. carry kernel, `gru_bwd_carry_cols<T, N>`: a block owns 8 N output
//      columns k of one direction and group of 8 rows, and one of P slices
//      of the 3H contraction rows; its 8 warps take 4 contraction rows g at
//      a time, 8 lanes a row, each lane one 16-byte load of W_hh[g, k..] and
//      the 8 rows' da_cat[g] (two broadcast float4 loads), the next two
//      rows' loads in flight. A two-stage reduce-scatter of shuffles and a
//      sum over the warps in shared memory, in a fixed order, leave the
//      block's partial product; it is stored in slice p of the scratch.
//      P is the most slices that one wave of carry blocks holds by
//      occupancy (B = 8, H = 1024, float32: 32 column tiles x 2
//      directions, two blocks an SM, so P = 4 and 256 blocks), where one
//      block a 16-column tile and all of 3H made 128 blocks. A second,
//      partial wave costs more than the longer slices save (PERF.md has
//      the times of P = 1 to 12).
// The next gate kernel adds the carry in as round(dh z + (p_1 + .. + p_P)),
// the slices in order, rounded to the activation type as the TPU kernel
// rounds its carry. No atomics: a call gives the same bits run to run.
//
// Steps after the first launch use programmatic dependent launch: each
// kernel lets the next one start at once, and a started kernel issues its
// first W_hh loads (and the gate kernel stages h_{t-1}, an input of the
// call, and sums the products of its first unit) before griddepcontrol.wait,
// which returns when the previous launch has ended and its writes are
// visible; the gate kernel waits before it reads the carry, the carry
// kernel before it reads da_cat. Nothing is written before the wait. The
// first launch of a call is a plain one: it waits for all earlier work on
// the stream.
//
// Bound on an H100 at the training shape (T=64, B=8, H=1024, float32): two
// B x 3H x H products per direction per step, 2 * 2 * 64 * 2 * 8 * 3072 *
// 1024 = 12.9 GFLOP, 0.19 ms at 67 TFLOP/s; its device-memory bytes (xw,
// h_prev, dout, dxw, danp, W_hh once: about 63 MB) take 0.02 ms. At B = 8
// each launch reads all of W_hh from L2 for 8 rows of work, so a reverse
// step is two L2 streams of 25.2 MB (plus h staged once a block and da_cat
// read once a column tile, 6.3 MB), about 7-8 us each at the 4 TB/s the
// forward reaches, and the call's 127 launches come to about 1 ms.

constexpr int CARRY_WARPS = 8;                // warps of a carry block
constexpr int CARRY_THREADS = 32 * CARRY_WARPS;
constexpr int CARRY_LANES = 8;                // lanes across a W_hh row
constexpr int CARRY_SLOTS = CARRY_THREADS / CARRY_LANES;  // rows g at once: 32
constexpr int CARRY_DEPTH = 2;                // rows g a lane loads a stage
constexpr int BWD_MAX_PARTS = 12;             // slices P of 3H, at most
constexpr int DA_ROWS = 8;                    // batch rows of a da_cat group

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// grid (ceil(H / span), ceil(B / R), 2), FWD_THREADS threads, dynamic
// shared memory R * HP floats, as the forward's step kernel. `carry` (1 +
// BWD_MAX_PARTS, 2, B, H) float: slot 0, dh z of the step after (read where
// parts > 0) and of this step (written); slots 1..parts, the partial
// products of the carry kernel after. `da` (2, ceil(B/8), 3H, 8) float:
// out, the gate grads of this step.
template <typename T, int R, int N>
__global__ void __launch_bounds__(FWD_THREADS) gru_bwd_gate_rows(
    const T* __restrict__ xw, const T* __restrict__ h_prev,
    const T* __restrict__ dout, const T* __restrict__ w_hh,
    const float* __restrict__ b_hh, T* __restrict__ dxw,
    T* __restrict__ danp, float* __restrict__ carry, float* __restrict__ da,
    int t, int B, int H, int span, int parts) {
  using Raw = typename Vec<T, N>::raw;
  constexpr int LANES = 32 / R;               // lanes that end with a row
  constexpr int CH = 32 * FWD_DEPTH;          // vectors of a row a stage
  extern __shared__ __align__(16) float hs[];  // [R][HP]: h_{t-1}, float
  const int HP = (H + 3) & ~3;
  const int d = blockIdx.z;
  const int b0 = blockIdx.y * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t G = 3 * (size_t)H;
  const size_t BH = (size_t)B * H;
  const size_t slab = (size_t)t * 2 + d;      // (t, d) slab index
  const int j0 = static_cast<int>(blockIdx.x) * span;
  const int j_end = min(H, j0 + span);
  const int rounds = j0 + warp < j_end
                         ? (j_end - j0 - warp + FWD_WARPS - 1) / FWD_WARPS
                         : 0;
  const int row = lane / LANES;
  const int b = b0 + row;
  const int groups8 = (B + DA_ROWS - 1) / DA_ROWS;
  const bool lead = lane % LANES == 0;
  const bool writes = lead && b < B;
  // rows past B in the last da_cat group feed no stored output: zeros
  const bool zeros = lead && b >= B && b < groups8 * DA_ROWS;
  // read or written only where `writes` (da_rows also where `zeros`)
  const T* x = xw + (slab * B + b) * G;
  const T* dy = dout + (slab * B + b) * H;
  T* dx = dxw + (slab * B + b) * G;
  T* dnp = danp + (slab * B + b) * H;
  float* dhz = carry + d * BH + (size_t)b * H;
  float* da_rows = da + ((size_t)d * groups8 + b / DA_ROWS) * G * DA_ROWS +
                   b % DA_ROWS;
  const float* bh = b_hh + (size_t)d * G;
  float xv[3], bv[3], dyv = 0.0f;             // a unit's gate inputs

  let_next_step_start();
  const T* w = w_hh + (size_t)d * G * H;
  const int HV = H / N;                       // vectors a row of h or W_hh
  const int nch = (HV + CH - 1) / CH;         // stages a unit
  const int total = rounds * nch;             // stages of this warp

  auto fetch = [&](Raw(&buf)[FWD_DEPTH][3], int it) {
    const int q = it / nch, c = it - q * nch;
    const int j = j0 + q * FWD_WARPS + warp;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const T* wrow = w + ((size_t)g * H + j) * H;
#pragma unroll
      for (int s = 0; s < FWD_DEPTH; ++s) {
        const int v = (c * FWD_DEPTH + s) * 32 + lane;
        if (v < HV)
          buf[s][g] = *reinterpret_cast<const Raw*>(wrow + (size_t)v * N);
      }
    }
  };

  Raw cur[FWD_DEPTH][3], nxt[FWD_DEPTH][3];
  if (total > 0) fetch(cur, 0);               // in flight while h is staged
  // h_{t-1} = h_prev[t, d] of the block's rows, an input of the call;
  // rows past B are zeros
  const T* hp = h_prev + slab * BH;
#pragma unroll 4
  for (int e = threadIdx.x; e < R * HV; e += FWD_THREADS) {
    const int i = e / HV, v = e - i * HV;
    float f[N];
    if (b0 + i < B) {
      unpack(*reinterpret_cast<const Raw*>(hp + (size_t)(b0 + i) * H +
                                           (size_t)v * N),
             f);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) f[n] = 0.0f;
    }
    store_h<N>(hs + i * HP + v * N, f);
  }
  __syncthreads();

  float acc[3][R];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[g][i] = 0.0f;

  bool waited = false;
  for (int it = 0; it < total; ++it) {
    const int q = it / nch, c = it - q * nch;
    const int j = j0 + q * FWD_WARPS + warp;
    if (it + 1 < total) fetch(nxt, it + 1);
    if (c == 0 && writes) {
      load_gates(x, bh, j, H, xv, bv);
      dyv = to_f(dy[j]);
    }
#pragma unroll
    for (int s = 0; s < FWD_DEPTH; ++s) {
      const int v = (c * FWD_DEPTH + s) * 32 + lane;
      if (v < HV) {
        float wv[3][N];
#pragma unroll
        for (int g = 0; g < 3; ++g) unpack(cur[s][g], wv[g]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float hv[N];
          load_h<N>(hs + i * HP + v * N, hv);
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int n = 0; n < N; ++n)
              acc[g][i] = fmaf(hv[n], wv[g][n], acc[g][i]);
        }
      }
    }
    if (c == nch - 1) {                       // unit j is summed
      float sum[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        sum[g] = reduce_rows<R>(acc[g], lane);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[g][i] = 0.0f;
      }
      if (!waited) {                          // the carry kernel's partials
        wait_for_previous_step();
        waited = true;
      }
      if (writes) {
        float carry_in = 0.0f;
        if (parts > 0) {
          float p = 0.0f;
          for (int s = 1; s <= parts; ++s)
            p += carry[((size_t)s * 2 + d) * BH + (size_t)b * H + j];
          carry_in = round_to<T>(dhz[j] + p);
        }
        const float r = sigmoidf(xv[0] + (sum[0] + bv[0]));
        const float z = sigmoidf(xv[1] + (sum[1] + bv[1]));
        const float npre = sum[2] + bv[2];
        const float n = tanhf(xv[2] + r * npre);
        const float h = hs[row * HP + j];
        const float dh = dyv + carry_in;
        const float dn = dh * (1.0f - z);
        const float dz = dh * (h - n);
        const float da_n = dn * (1.0f - n * n);
        const float da_z = dz * z * (1.0f - z);
        const float dr = da_n * npre;
        const float da_r = dr * r * (1.0f - r);
        const float da_np = da_n * r;
        dx[j] = from_f<T>(da_r);
        dx[H + j] = from_f<T>(da_z);
        dx[2 * H + j] = from_f<T>(da_n);
        dnp[j] = from_f<T>(da_np);
        da_rows[(size_t)j * DA_ROWS] = round_to<T>(da_r);
        da_rows[((size_t)H + j) * DA_ROWS] = round_to<T>(da_z);
        da_rows[((size_t)2 * H + j) * DA_ROWS] = round_to<T>(da_np);
        dhz[j] = dh * z;                      // the carry kernel adds da W
      } else if (zeros) {
        da_rows[(size_t)j * DA_ROWS] = 0.0f;
        da_rows[((size_t)H + j) * DA_ROWS] = 0.0f;
        da_rows[((size_t)2 * H + j) * DA_ROWS] = 0.0f;
      }
    }
#pragma unroll
    for (int s = 0; s < FWD_DEPTH; ++s)
#pragma unroll
      for (int g = 0; g < 3; ++g) cur[s][g] = nxt[s][g];
  }
}

// grid (ceil(H / (CARRY_LANES N)), P, 2 ceil(B/8)): block (x, p, d *
// ceil(B/8) + group) sums da[d, group, g, i] W_hh[d, g, k] over its slice
// g in [p gslice, (p + 1) gslice) of 3H for the group's 8 rows i and its
// CARRY_LANES N columns k, into carry slot 1 + p. N values of a W_hh row a
// load (N divides H on the vector path).
template <typename T, int N>
__global__ void __launch_bounds__(CARRY_THREADS, N <= 4 ? 2 : 1)
    gru_bwd_carry_cols(const T* __restrict__ w_hh,
                       const float* __restrict__ da,
                       float* __restrict__ carry, int B, int H, int gslice) {
  using Raw = typename Vec<T, N>::raw;
  constexpr int CC = CARRY_LANES * N;         // columns of a block
  __shared__ float red[CARRY_WARPS][DA_ROWS][CC];
  const int groups8 = (B + DA_ROWS - 1) / DA_ROWS;
  const int d = blockIdx.z / groups8, grp = blockIdx.z % groups8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cl = lane % CARRY_LANES;
  const int slot = warp * (32 / CARRY_LANES) + lane / CARRY_LANES;
  const int G = 3 * H;
  const int k = blockIdx.x * CC + cl * N;     // the lane's first column
  const bool live = k < H;
  const int gbeg = blockIdx.y * gslice;
  const int gend = min(G, gbeg + gslice);
  // rows g of this lane: gbeg + slot + CARRY_SLOTS i, i < iters
  const int iters = gbeg + slot < gend
                        ? (gend - gbeg - slot + CARRY_SLOTS - 1) / CARRY_SLOTS
                        : 0;
  const int stages = (iters + CARRY_DEPTH - 1) / CARRY_DEPTH;
  const T* w = w_hh + (size_t)d * G * H + k;
  const float* a = da + ((size_t)d * groups8 + grp) * G * DA_ROWS;

  let_next_step_start();
  auto fetch_w = [&](Raw(&buf)[CARRY_DEPTH], int s) {
#pragma unroll
    for (int q = 0; q < CARRY_DEPTH; ++q) {
      const int i = s * CARRY_DEPTH + q;
      if (live && i < iters)
        buf[q] = *reinterpret_cast<const Raw*>(
            w + (size_t)(gbeg + slot + i * CARRY_SLOTS) * H);
    }
  };
  auto fetch_a = [&](float4(&buf)[CARRY_DEPTH][2], int s) {
#pragma unroll
    for (int q = 0; q < CARRY_DEPTH; ++q) {
      const int i = s * CARRY_DEPTH + q;
      if (i < iters) {
        const float4* p = reinterpret_cast<const float4*>(
            a + (size_t)(gbeg + slot + i * CARRY_SLOTS) * DA_ROWS);
        buf[q][0] = p[0];
        buf[q][1] = p[1];
      }
    }
  };

  float acc[DA_ROWS][N];
#pragma unroll
  for (int i = 0; i < DA_ROWS; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.0f;
  Raw wc[CARRY_DEPTH], wn[CARRY_DEPTH];
  float4 ac[CARRY_DEPTH][2], an[CARRY_DEPTH][2];
  if (stages > 0) fetch_w(wc, 0);
  wait_for_previous_step();                   // da of this step
  if (stages > 0) fetch_a(ac, 0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      fetch_w(wn, s + 1);
      fetch_a(an, s + 1);
    }
#pragma unroll
    for (int q = 0; q < CARRY_DEPTH; ++q) {
      if (live && s * CARRY_DEPTH + q < iters) {
        float wv[N];
        unpack(wc[q], wv);
        const float av[DA_ROWS] = {ac[q][0].x, ac[q][0].y, ac[q][0].z,
                                   ac[q][0].w, ac[q][1].x, ac[q][1].y,
                                   ac[q][1].z, ac[q][1].w};
#pragma unroll
        for (int i = 0; i < DA_ROWS; ++i)
#pragma unroll
          for (int n = 0; n < N; ++n)
            acc[i][n] = fmaf(av[i], wv[n], acc[i][n]);
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_DEPTH; ++q) {
      wc[q] = wn[q];
      ac[q][0] = an[q][0];
      ac[q][1] = an[q][1];
    }
  }

  // the warp's 4 rows g of each column: a reduce-scatter over lane bits 4
  // and 3 leaves rows i0, i0 + 1 (i0 from those bits) summed in each lane
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bool up = lane & 16;
      const float send = up ? acc[i][n] : acc[i + 4][n];
      const float keep = up ? acc[i + 4][n] : acc[i][n];
      acc[i][n] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bool up = lane & 8;
      const float send = up ? acc[i][n] : acc[i + 2][n];
      const float keep = up ? acc[i + 2][n] : acc[i][n];
      acc[i][n] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  const int i0 = (lane & 16 ? 4 : 0) + (lane & 8 ? 2 : 0);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) red[warp][i0 + i][cl * N + n] = acc[i][n];
  __syncthreads();
  const size_t BH = (size_t)B * H;
  float* part = carry + ((size_t)(1 + blockIdx.y) * 2 + d) * BH;
  for (int o = threadIdx.x; o < DA_ROWS * CC; o += CARRY_THREADS) {
    const int i = o / CC, c = o - i * CC;
    const int bb = grp * DA_ROWS + i, kk = blockIdx.x * CC + c;
    if (bb >= B || kk >= H) continue;
    float sum = 0.0f;
#pragma unroll
    for (int v = 0; v < CARRY_WARPS; ++v) sum += red[v][i][c];
    part[(size_t)bb * H + kk] = sum;
  }
}

// The 2T - 1 launches with R rows a gate block, steps after the first with
// programmatic dependent launch where `pdl`. The gate kernel's span makes
// one wave, as the forward's; so do the carry kernel's slices P of 3H
// (parts 0; at most BWD_MAX_PARTS, at least 32 rows g a slice).
template <typename T, int R, int N>
int launch_bwd_rows(const void* xw, const void* h_prev, const void* dout,
                    const void* w_hh, const void* b_hh, void* dxw,
                    void* danp, void* carry, void* da, int T_, int B, int H,
                    int parts, bool pdl, cudaStream_t stream) {
  const auto gate = gru_bwd_gate_rows<T, R, N>;
  const auto carry_k = gru_bwd_carry_cols<T, N>;
  const size_t smem = sizeof(float) * R * (size_t)((H + 3) & ~3);
  int dev = 0, sms = 0, per_sm = 0, carry_per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      gate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gate,
                                                        FWD_THREADS, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &carry_per_sm, carry_k, CARRY_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1 || carry_per_sm < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = (B + R - 1) / R;
  const long rounds = (H + FWD_WARPS - 1) / FWD_WARPS;   // of all H units
  const long slots = (long)sms * per_sm;
  const int span =
      static_cast<int>((rounds * groups * 2 + slots - 1) / slots) * FWD_WARPS;
  const dim3 gate_grid((H + span - 1) / span, groups, 2);

  const int G = 3 * H;
  const int cols = CARRY_LANES * N;
  const int gx = (H + cols - 1) / cols;
  const int gz = 2 * ((B + DA_ROWS - 1) / DA_ROWS);
  // parts 0: as many slices as one wave of carry blocks holds
  if (parts == 0) parts = sms * carry_per_sm / (gx * gz);
  parts = max(1, min(parts, min(BWD_MAX_PARTS,
                                (G + CARRY_SLOTS - 1) / CARRY_SLOTS)));
  const int gslice =
      ((G + parts - 1) / parts + CARRY_SLOTS - 1) / CARRY_SLOTS * CARRY_SLOTS;
  parts = (G + gslice - 1) / gslice;
  const dim3 carry_grid(gx, parts, gz);

  const T* x = static_cast<const T*>(xw);
  const T* hp = static_cast<const T*>(h_prev);
  const T* dy = static_cast<const T*>(dout);
  const T* w = static_cast<const T*>(w_hh);
  const float* bias = static_cast<const float*>(b_hh);
  T* dx = static_cast<T*>(dxw);
  T* dnp = static_cast<T*>(danp);
  float* c = static_cast<float*>(carry);
  float* a = static_cast<float*>(da);
  const float* ac = a;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t gcfg = {};
  gcfg.gridDim = gate_grid;
  gcfg.blockDim = dim3(FWD_THREADS);
  gcfg.dynamicSmemBytes = smem;
  gcfg.stream = stream;
  gcfg.attrs = &attr;
  gcfg.numAttrs = 1;
  cudaLaunchConfig_t ccfg = gcfg;
  ccfg.gridDim = carry_grid;
  ccfg.blockDim = dim3(CARRY_THREADS);
  ccfg.dynamicSmemBytes = 0;
  for (int t = T_ - 1; t >= 0; --t) {
    const int in = t < T_ - 1 ? parts : 0;  // partials of the carry after
    // the first launch waits for all earlier work on the stream
    if (pdl && t < T_ - 1) {
      err = cudaLaunchKernelEx(&gcfg, gate, x, hp, dy, w, bias, dx, dnp, c,
                               a, t, B, H, span, in);
    } else {
      gate<<<gate_grid, FWD_THREADS, smem, stream>>>(
          x, hp, dy, w, bias, dx, dnp, c, a, t, B, H, span, in);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (t == 0) break;                 // the grad of h0 is not needed
    if (pdl) {
      err = cudaLaunchKernelEx(&ccfg, carry_k, w, ac, c, B, H, gslice);
    } else {
      carry_k<<<carry_grid, CARRY_THREADS, 0, stream>>>(w, ac, c, B, H,
                                                        gslice);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows 0 picks R from B and H as the forward does; 8, 16 or 32 forces it.
// parts 0 picks the carry kernel's slices of 3H; 1.. forces them.
template <typename T, int N>
int launch_bwd(const void* xw, const void* h_prev, const void* dout,
               const void* w_hh, const void* b_hh, void* dxw, void* danp,
               void* carry, void* da, int T_, int B, int H, int rows,
               int parts, bool pdl, cudaStream_t stream) {
  if (rows == 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    rows = B <= 8 ? 8 : B <= 16 ? 16 : 32;
    while (rows > 8 && sizeof(float) * rows * (size_t)((H + 3) & ~3) >
                           static_cast<size_t>(optin))
      rows /= 2;
  }
  // 16-byte loads need 16-byte aligned rows of W_hh and h_prev, and da's
  // float4 groups a 16-byte aligned base
  if (reinterpret_cast<uintptr_t>(da) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = H % N == 0 &&
                   reinterpret_cast<uintptr_t>(w_hh) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h_prev) % 16 == 0;
#define BWD_LAUNCH(R, V)                                                    \
  if (rows == R)                                                            \
  return launch_bwd_rows<T, R, V>(xw, h_prev, dout, w_hh, b_hh, dxw, danp, \
                                  carry, da, T_, B, H, parts, pdl, stream)
  if (vec) {
    BWD_LAUNCH(8, N);
    BWD_LAUNCH(16, N);
    BWD_LAUNCH(32, N);
  } else {
    BWD_LAUNCH(8, 1);
    BWD_LAUNCH(16, 1);
    BWD_LAUNCH(32, 1);
  }
#undef BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// T launches (0 on success). Launches on `stream`, does not synchronise.
extern "C" int gru_scan_fwd(const void* xw, const void* w_hh,
                            const void* b_hh, void* out, int T_, int B, int H,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float, 4>(xw, w_hh, b_hh, out, T_, B, H, 0, true, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, 8>(xw, w_hh, b_hh, out, T_, B, H, 0,
                                        true, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gru_scan_fwd with the choices forced, for measuring them: `rows` batch
// rows a block (8, 16 or 32); `pdl` 1 for programmatic dependent launch of
// steps 1.., 0 for plain launches.
extern "C" int gru_scan_fwd_rows(const void* xw, const void* w_hh,
                                 const void* b_hh, void* out, int T_, int B,
                                 int H, int dtype, int rows, int pdl,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_fwd<float, 4>(xw, w_hh, b_hh, out, T_, B, H, rows,
                                pdl != 0, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, 8>(xw, w_hh, b_hh, out, T_, B, H, rows,
                                        pdl != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The number of (2, B, H) float32 slots of the backward's carry scratch:
// dh z, then up to BWD_MAX_PARTS partial products.
extern "C" int gru_scan_bwd_carry_slots() { return 1 + BWD_MAX_PARTS; }

// The backward pass (2T - 1 launches). xw, dout, h_prev (T, 2, B, 3H|H|H),
// w_hh (2, 3H, H) in the activation type, b_hh (2, 3H) float32; outputs
// dxw (T, 2, B, 3H) and danp (T, 2, B, H) in the activation type. Scratch,
// allocated by the caller: carry (gru_scan_bwd_carry_slots(), 2, B, H) and
// da (2, ceil(B/8), 3H, 8), both float32, da 16-byte aligned. dtype and the
// return value as for gru_scan_fwd.
extern "C" int gru_scan_bwd(const void* xw, const void* h_prev,
                            const void* dout, const void* w_hh,
                            const void* b_hh, void* dxw, void* danp,
                            void* carry, void* da, int T_, int B, int H,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float, 4>(xw, h_prev, dout, w_hh, b_hh, dxw, danp,
                                carry, da, T_, B, H, 0, 0, true, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, 8>(xw, h_prev, dout, w_hh, b_hh, dxw,
                                        danp, carry, da, T_, B, H, 0, 0,
                                        true, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gru_scan_bwd with the choices forced, for measuring them: `rows` batch
// rows a gate block (8, 16 or 32, or 0 to pick); `parts` slices of 3H in
// the carry kernel (1 to BWD_MAX_PARTS, or 0 to pick); `pdl` 1 for
// programmatic dependent launch of the launches after the first, 0 for
// plain launches.
extern "C" int gru_scan_bwd_cfg(const void* xw, const void* h_prev,
                                const void* dout, const void* w_hh,
                                const void* b_hh, void* dxw, void* danp,
                                void* carry, void* da, int T_, int B, int H,
                                int dtype, int rows, int parts, int pdl,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 0 || parts < 0 || parts > BWD_MAX_PARTS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_bwd<float, 4>(xw, h_prev, dout, w_hh, b_hh, dxw, danp,
                                carry, da, T_, B, H, rows, parts, pdl != 0,
                                s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, 8>(xw, h_prev, dout, w_hh, b_hh, dxw,
                                        danp, carry, da, T_, B, H, rows,
                                        parts, pdl != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

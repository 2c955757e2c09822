// Fused brand-aspect dropout + mean, forward and backward -- the JAX
// package's Pallas kernels `aspect_dropout_mean` (`_fwd_impl` /
// `_fwd_kernel`) and `_adm_bwd` (`_bwd_kernel`) in
// fancyrec_tpu/ops/brand_pallas.py.
//
//   out[b, c]  = s * sum_a m[b, a, c] w[b, a] asp[a, c]
//   dw[b, a]   = s * sum_c m[b, a, c] g[b, c] asp[a, c]
//   dasp[a, c] = s * sum_b m[b, a, c] g[b, c] w[b, a]
//
// with s = 1 / (A keep) and the keep mask m = (word <= thr), thr =
// min(int(keep 2^32) - 1, 2^32 - 1), so keep = 1 keeps every element.
// w (B, A), asp (A, C), g and out (B, C), all float32.
//
// Random bits. The TPU kernel draws from the TPU's hardware generator,
// which has no counterpart here. The words are Philox4x32-10 (Salmon et
// al., SC'11; Random123's constants), keyed by the two seed words, which
// the forward reads from device memory, so that a captured launch takes
// the words of each replay. Element (b, a, c) takes word e & 3 of the
// Philox block at counter e >> 2, where e = (b A + a) C + c: a pure
// function of the element, not of the launch geometry. The mask follows
// the batch row b, not the brand id.
//
// An aspect shard (tensor parallelism: a model rank holds aspects
// [a_off, a_off + A) of a table of A_total) draws the counters of its
// global aspects in the whole table, e = (b A_total + a_off + a) C + c, so
// the shards' masks are the slices of the table's mask; the caller's scale
// is 1 / (A_total keep), and the shards' outputs sum to the table's. w, asp
// and the bits are the shard's own: their rows and strides are the local
// A. The backward reads the shard's bits and needs no global index.
//
// The forward draws the mask and writes it as bits: `bits` is int32
// (B, A, ceil(C / 32)), bit c & 31 of word c >> 5 in row (b, a) set where
// element (b, a, c) is kept, the tail bits past C zero. The backward reads
// those bits and draws nothing. On the TPU the backward replays its
// generator, which suits VMEM and its lanes; here a Philox block takes 44
// integer instructions of SASS (18 of them 32 x 32 -> 64-bit multiplies)
// for 4 bits, while the packed bits of the training shape (2.05 MB) take
// about 1.2 microseconds to write and read back at 3.35 TB/s.
//
// Forward design. A block owns 128 columns (4 a lane), 8 batch rows and a span
// of aspects (a split of A); its 8 warps take the span's aspects in turn. A
// thread keeps acc[8][4] for its 4 columns and every row, so each asp tile
// comes from device memory once, and it draws 8 independent Philox blocks an
// aspect (one a row, in one basic block: rows past B are drawn and dropped),
// whose chains hide each other's multiply latency. The 10 round keys are
// computed once a thread, into registers. The next aspect's asp row is loaded
// while the current one's Philox rounds run; w of the span sits in shared
// memory. Each lane holds its 4 keep bits of the 8 rows as 8 nibbles; an 8 x 8
// nibble transpose across each 8-lane group (three shuffles) gives each lane
// one row's 32-bit word, which it stores. The 8 warps' sums are added in a
// fixed order through shared memory into a scratch slot of the split, and a
// second kernel, started early by programmatic dependent launch (PDL), adds
// the splits' slots in split order and scales them. The splits are picked
// (`ops.brand_dropout.aspect_dropout_plan`) for one wave of two blocks an SM.
// Backward design. A group of 4 aspect rows and all C (in chunks of 1024
// columns, 4 a thread) is summed by one block: its asp rows and dasp sums
// in registers, the keep bits of its rows for 8 batch rows at a time, and
// the 32 dw sums of those 8 x 4 (b, a) pairs reduced over the columns by a
// reduce-scatter across each warp's lanes (31 shuffles) and the 8 warps in
// order through shared memory. Where C % 4 == 0, C <= 1024 and B <= 8 (the
// training microbatch), the plan gives `adm_bwd_stream` two persistent
// blocks an SM that take the groups in turn, g held in registers, and bring the next
// group's asp rows, keep bits and w into shared memory by cp.async while
// they sum the current one; elsewhere `adm_bwd_kernel` takes a group a
// block. Both add in the same order. No atomics anywhere: results are the
// same run to run.
//
// Bounds on an H100 at the training shape (B = 8, A = 2000, C = 1024). The
// forward draws 4.1M Philox4x32-10 blocks: its integer work (counted from
// the SASS of its per-block step by chip_smoke.py) bounds it; its bytes
// (asp 8.2 MB in, 2.05 MB of bits out) take 3.1 microseconds at 3.35
// TB/s. The backward streams bytes: asp in and dasp out (8.2 MB each),
// the bits (2.05 MB), w, g and dw: 18.6 MB, 5.6 microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

// The key of each of the 10 rounds: round r adds r (W0, W1) to the seed
// words. The same across the grid: computed once a thread.
struct RoundKeys {
  uint32_t x[10], y[10];
};

__device__ __forceinline__ RoundKeys round_keys(uint2 k) {
  RoundKeys rk;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    rk.x[r] = k.x + static_cast<uint32_t>(r) * PHILOX_W0;
    rk.y[r] = k.y + static_cast<uint32_t>(r) * PHILOX_W1;
  }
  return rk;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const RoundKeys& rk) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ rk.x[r], lo1, hi0 ^ c.w ^ rk.y[r], lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t keep_bits(uint4 r, uint32_t thr) {
  return (r.x <= thr) | ((r.y <= thr) << 1) | ((r.z <= thr) << 2) |
         ((r.w <= thr) << 3);
}

// One Philox block of the forward, where the counters fit 32 bits: the
// keep bits of the 4 columns of counter q as bits SHIFT .. SHIFT + 3 (bit
// SHIFT + i for column 4 (q mod C/4) + i), the kept products wv * av added
// to acc. The loop the forward runs calls this once a row of each aspect,
// the row's nibble at SHIFT = 4 r: each bit one select of an immediate.
template <int SHIFT>
__device__ __forceinline__ uint32_t fwd_block(uint32_t q, const RoundKeys& rk,
                                              uint32_t thr, float wv,
                                              float4 av, float (&acc)[4]) {
  const uint4 r = philox4x32_10(make_uint4(q, 0u, 0u, 0u), rk);
  const bool k0 = r.x <= thr, k1 = r.y <= thr, k2 = r.z <= thr,
             k3 = r.w <= thr;
  if (k0) acc[0] = fmaf(wv, av.x, acc[0]);
  if (k1) acc[1] = fmaf(wv, av.y, acc[1]);
  if (k2) acc[2] = fmaf(wv, av.z, acc[2]);
  if (k3) acc[3] = fmaf(wv, av.w, acc[3]);
  return (k0 ? 1u << SHIFT : 0u) | (k1 ? 2u << SHIFT : 0u) |
         (k2 ? 4u << SHIFT : 0u) | (k3 ? 8u << SHIFT : 0u);
}

__device__ __forceinline__ uint32_t word_at(uint64_t e, const RoundKeys& rk) {
  const uint64_t q = e >> 2;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32), 0u,
                 0u),
      rk);
  switch (e & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// Keep bits of elements e0 .. e0+3 (bit i for e0 + i), any counter: with
// C % 4 == 0 one Philox block holds all four words, else each element
// takes its own.
__device__ __forceinline__ uint32_t keep4_any(uint64_t e0, const RoundKeys& rk,
                                              uint32_t thr, bool aligned) {
  if (aligned) {
    const uint64_t q = e0 >> 2;
    return keep_bits(
        philox4x32_10(make_uint4(static_cast<uint32_t>(q),
                                 static_cast<uint32_t>(q >> 32), 0u, 0u),
                      rk),
        thr);
  }
  return keep_bits(make_uint4(word_at(e0, rk), word_at(e0 + 1, rk),
                              word_at(e0 + 2, rk), word_at(e0 + 3, rk)),
                   thr);
}

// 4 consecutive floats of a row from column c0, zero past C.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c0,
                                        int C, bool aligned) {
  if (aligned && c0 + 3 < C)
    return __ldg(reinterpret_cast<const float4*>(row + c0));
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = c0 + i < C ? __ldg(row + c0 + i) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Programmatic dependent launch: the forward's blocks let the sum kernel
// start; the sum kernel waits until the forward has ended and its writes
// are visible. Both are no-ops in a kernel launched without the attribute.
__device__ __forceinline__ void let_dependents_start() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

constexpr int F_WARPS = 8;
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_COLS = 128;       // columns a block, 4 a lane
constexpr int F_ROWS = 8;         // batch rows a block: 8 nibbles a word
constexpr int F_MAX_SPAN = 256;   // aspects a split, at most

// grid (ceil(C / F_COLS), splits, ceil(B / F_ROWS)). Block (x, y, z) sums
// local aspects [y span, (y + 1) span) of rows [8 z, 8 z + 8) and columns
// [128 x, 128 x + 128) into part[y][b][128 x ...] (rows of CP = 128
// gridDim.x floats), and writes those rows' and aspects' keep bits. The
// counters are of global aspect a_off + a in a table of A_total. FAST:
// C % 4 == 0 and every counter below 2^32.
template <bool FAST, bool BITS>
__global__ void __launch_bounds__(F_THREADS, 2) adm_fwd_kernel(
    const float* __restrict__ w, const float* __restrict__ asp,
    float* __restrict__ part, uint32_t* __restrict__ bits, int B, int A,
    int C, int A_total, int a_off, int span,
    const unsigned long long* __restrict__ key, uint32_t thr) {
  __shared__ float4 ws[F_MAX_SPAN][F_ROWS / 4];        // w of the span
  __shared__ float4 red[F_WARPS][F_ROWS][32];          // the warps' sums
  let_dependents_start();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * F_COLS + 4 * lane;
  const int b0 = blockIdx.z * F_ROWS;
  const int a_lo = blockIdx.y * span, a_hi = min(A, a_lo + span);
  const bool aligned = (C & 3) == 0;
  const RoundKeys rk =
      round_keys(make_uint2(static_cast<uint32_t>(__ldg(key)),
                            static_cast<uint32_t>(__ldg(key + 1))));
  // the first asp row is on its way while w fills shared memory
  int a = a_lo + warp;
  float4 next = a < a_hi ? load4(asp + (size_t)a * C, c0, C, aligned)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float* wsf = reinterpret_cast<float*>(ws);
  for (int i = threadIdx.x; i < span * F_ROWS; i += F_THREADS) {
    const int j = i / F_ROWS, r = i % F_ROWS;
    wsf[i] = b0 + r < B && a_lo + j < A ? w[(size_t)(b0 + r) * A + a_lo + j]
                                        : 0.0f;
  }
  // the nibble transpose: in stage s (lane distance d = 4, 2, 1) a lane
  // keeps the nibbles whose position has bit d as its own lane index has
  // it, and takes the others from its partner, rotated by 4 d bits
  uint32_t keep_mask[3], rot[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int d = 4 >> s;
    const uint32_t low = s == 0 ? 0x0000FFFFu : s == 1 ? 0x00FF00FFu
                                                       : 0x0F0F0F0Fu;
    const bool up = lane & d;
    keep_mask[s] = up ? ~low : low;
    rot[s] = up ? 4 * d : 32 - 4 * d;
  }
  // the columns of this lane inside C, as a bit in each of the 8 nibbles
  uint32_t col_ok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c0 + i < C) col_ok |= 0x11111111u << i;
  const int words = (C + 31) / 32;
  const int word = blockIdx.x * (F_COLS / 32) + lane / 8;
  const uint32_t cq = static_cast<uint32_t>(C) / 4;
  const uint32_t row_q = static_cast<uint32_t>(A_total) * cq;

  float acc[F_ROWS][4];
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  __syncthreads();

  for (; a < a_hi; a += F_WARPS) {
    const float4 av = next;
    if (a + F_WARPS < a_hi)
      next = load4(asp + (size_t)(a + F_WARPS) * C, c0, C, aligned);
    const float4 w_lo = ws[a - a_lo][0], w_hi = ws[a - a_lo][1];
    const float wv[F_ROWS] = {w_lo.x, w_lo.y, w_lo.z, w_lo.w,
                              w_hi.x, w_hi.y, w_hi.z, w_hi.w};
    uint32_t nib = 0;   // nibble r: the keep bits of row b0 + r
    if (FAST) {
      const uint32_t qa = static_cast<uint32_t>(a_off + a) * cq +
                          static_cast<uint32_t>(c0) / 4 +
                          static_cast<uint32_t>(b0) * row_q;
      // rows past B (w zero) are drawn too: the 8 chains stay in one
      // basic block, and their bits and sums are never stored
      nib = fwd_block<0>(qa, rk, thr, wv[0], av, acc[0]) |
            fwd_block<4>(qa + row_q, rk, thr, wv[1], av, acc[1]) |
            fwd_block<8>(qa + 2 * row_q, rk, thr, wv[2], av, acc[2]) |
            fwd_block<12>(qa + 3 * row_q, rk, thr, wv[3], av, acc[3]) |
            fwd_block<16>(qa + 4 * row_q, rk, thr, wv[4], av, acc[4]) |
            fwd_block<20>(qa + 5 * row_q, rk, thr, wv[5], av, acc[5]) |
            fwd_block<24>(qa + 6 * row_q, rk, thr, wv[6], av, acc[6]) |
            fwd_block<28>(qa + 7 * row_q, rk, thr, wv[7], av, acc[7]);
    } else {
#pragma unroll
      for (int r = 0; r < F_ROWS; ++r) {
        if (b0 + r >= B) continue;
        const uint32_t m = keep4_any(
            ((uint64_t)(b0 + r) * A_total + a_off + a) * C + c0, rk, thr,
            aligned);
        if (m & 1u) acc[r][0] = fmaf(wv[r], av.x, acc[r][0]);
        if (m & 2u) acc[r][1] = fmaf(wv[r], av.y, acc[r][1]);
        if (m & 4u) acc[r][2] = fmaf(wv[r], av.z, acc[r][2]);
        if (m & 8u) acc[r][3] = fmaf(wv[r], av.w, acc[r][3]);
        nib |= m << (4 * r);
      }
    }
    if (BITS) {
      nib &= col_ok;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const uint32_t send =
            __funnelshift_l(nib, nib, rot[s]) & keep_mask[s];
        nib = (nib & keep_mask[s]) |
              __shfl_xor_sync(0xffffffffu, send, 4 >> s);
      }
      // lane 8 g + r now holds row b0 + r's word of columns [32 g, 32 g + 32)
      const int r = lane % 8;
      if (b0 + r < B && word < words)
        bits[((size_t)(b0 + r) * A + a) * words + word] = nib;
    }
  }

#pragma unroll
  for (int r = 0; r < F_ROWS; ++r)
    red[warp][r][lane] = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                     acc[r][3]);
  __syncthreads();
  // thread (r, l) = (warp, lane) adds row b0 + r of lane l's columns over
  // the 8 warps in order
  const int b = b0 + warp;
  if (b >= B) return;
  float4 s = red[0][warp][lane];
#pragma unroll
  for (int p = 1; p < F_WARPS; ++p) {
    const float4 v = red[p][warp][lane];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  const size_t cp = (size_t)gridDim.x * F_COLS;
  *reinterpret_cast<float4*>(part + ((size_t)blockIdx.y * B + b) * cp + c0) =
      s;
}

constexpr int S_THREADS = 256;
constexpr int S_BATCH = 32;       // splits whose loads are in flight at once

// out[b, c] = scale * sum over the splits, in split order, of
// part[split][b][c]; one float of a part row a thread
__global__ void __launch_bounds__(S_THREADS) adm_fwd_sum(
    const float* __restrict__ part, float* __restrict__ out, int B, int C,
    int cp, int splits, float scale) {
  wait_for_primary();
  const int n = B * cp;
  const int i = blockIdx.x * S_THREADS + threadIdx.x;
  if (i >= n || i % cp >= C) return;
  float s = 0.0f;
  for (int p0 = 0; p0 < splits; p0 += S_BATCH) {
    float v[S_BATCH];
#pragma unroll
    for (int k = 0; k < S_BATCH; ++k)
      v[k] = p0 + k < splits ? part[(size_t)(p0 + k) * n + i] : 0.0f;
#pragma unroll
    for (int k = 0; k < S_BATCH; ++k) s += v[k];
  }
  out[(size_t)(i / cp) * C + i % cp] = s * scale;
}

constexpr int B_ASP = 4;                   // aspect rows a block
constexpr int B_ROWS = 8;                  // batch rows a pass
constexpr int B_THREADS = 256;             // 4 columns each: 1024 a chunk
constexpr int B_WARPS = B_THREADS / 32;
constexpr int B_SUMS = B_ASP * B_ROWS;      // dw sums a pass, one a lane
static_assert(B_SUMS == 32, "one dw sum a lane");

// The warp's sum of entry `lane` of p, by a reduce-scatter in a fixed
// order: after the stage of distance d a lane holds, in p[0 .. d), the pair
// sums of the half of the entries its bit d selects. p is used up.
__device__ __forceinline__ float reduce_scatter(float (&p)[B_SUMS], int lane) {
#pragma unroll
  for (int st = 0; st < 5; ++st) {
    const int d = 16 >> st;
    const bool up = lane & d;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < d) {
        const float send = up ? p[i] : p[i + d];
        const float keep = up ? p[i + d] : p[i];
        p[i] = keep + __shfl_xor_sync(0xffffffffu, send, d);
      }
    }
  }
  return p[0];
}

// grid (ceil(A / B_ASP))
__global__ void __launch_bounds__(B_THREADS, 2) adm_bwd_kernel(
    const float* __restrict__ w, const float* __restrict__ asp,
    const float* __restrict__ g, const uint32_t* __restrict__ bits,
    float* __restrict__ dw, float* __restrict__ dasp, int B, int A, int C,
    float scale) {
  __shared__ float ws[B_SUMS];                // w of the pass's (b, a)
  __shared__ float wpart[B_WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a0 = blockIdx.x * B_ASP;
  const bool aligned = (C & 3) == 0;
  const int words = (C + 31) / 32;

  for (int cbase = 0; cbase < C; cbase += 4 * B_THREADS) {
    const int c0 = cbase + 4 * threadIdx.x;
    const bool col_ok = c0 < C;
    const int cl = col_ok ? c0 : 0;          // a column inside C, to load
    const bool last = cbase + 4 * B_THREADS >= C;
    float av[B_ASP][4], da[B_ASP][4];
#pragma unroll
    for (int j = 0; j < B_ASP; ++j) {
      const float4 v = load4(asp + (size_t)min(a0 + j, A - 1) * C, c0, C,
                             aligned);
      av[j][0] = v.x; av[j][1] = v.y; av[j][2] = v.z; av[j][3] = v.w;
      da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0.0f;
    }
    for (int bt = 0; bt < B; bt += B_ROWS) {
      if (threadIdx.x < B_SUMS) {
        const int b = bt + threadIdx.x / B_ASP, a = a0 + threadIdx.x % B_ASP;
        ws[threadIdx.x] = b < B && a < A ? w[(size_t)b * A + a] : 0.0f;
      }
      // every load of the pass first, none behind a branch: rows and
      // aspects past B and A read a row inside and take no keep bits
      uint32_t mb[B_ROWS][B_ASP];
      float4 gv[B_ROWS];
#pragma unroll
      for (int r = 0; r < B_ROWS; ++r) {
        const int b = min(bt + r, B - 1);
        gv[r] = load4(g + (size_t)b * C, c0, C, aligned);
#pragma unroll
        for (int j = 0; j < B_ASP; ++j) {
          const uint32_t v = __ldg(bits + ((size_t)b * A + min(a0 + j, A - 1))
                                              * words + cl / 32);
          mb[r][j] = bt + r < B && a0 + j < A && col_ok ? v >> (cl % 32) : 0u;
        }
      }
      __syncthreads();
      float p[B_SUMS];   // p[r B_ASP + j]: dw of (bt + r, a0 + j)
#pragma unroll
      for (int r = 0; r < B_ROWS; ++r) {
#pragma unroll
        for (int j = 0; j < B_ASP; ++j) {
          const uint32_t m = mb[r][j];
          const float wv = ws[r * B_ASP + j];
          float s = 0.0f;
          const float gq[4] = {gv[r].x, gv[r].y, gv[r].z, gv[r].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (m & (1u << q)) {
              da[j][q] = fmaf(gq[q], wv, da[j][q]);
              s = fmaf(gq[q], av[j][q], s);
            }
          }
          p[r * B_ASP + j] = s;
        }
      }
      wpart[warp][lane] = reduce_scatter(p, lane);
      __syncthreads();
      if (threadIdx.x < B_SUMS) {
        const int b = bt + threadIdx.x / B_ASP, a = a0 + threadIdx.x % B_ASP;
        if (b < B && a < A) {
          float s = wpart[0][threadIdx.x];
#pragma unroll
          for (int q = 1; q < B_WARPS; ++q) s += wpart[q][threadIdx.x];
          float* dp = dw + (size_t)b * A + a;
          const float v = cbase == 0 ? s : *dp + s;   // this thread's own
          *dp = last ? v * scale : v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < B_ASP; ++j) {
      if (a0 + j >= A) continue;
      float* row = dasp + (size_t)(a0 + j) * C;
      if (aligned && c0 + 3 < C) {
        *reinterpret_cast<float4*>(row + c0) =
            make_float4(da[j][0] * scale, da[j][1] * scale, da[j][2] * scale,
                        da[j][3] * scale);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c0 + i < C) row[c0 + i] = da[j][i] * scale;
      }
    }
  }
}

// cp.async: 16 or 4 bytes from device memory into shared memory, issued
// now and awaited by group (commit, then wait until at most N are pending)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

constexpr int S_COLS = 4 * B_THREADS;  // columns the streamed backward takes

// The backward where C % 4 == 0, C <= S_COLS and B <= B_ROWS (the training
// microbatch): persistent blocks, each taking groups of B_ASP aspects in
// turn (group k, k + gridDim.x, ...). g stays in registers; the next
// group's asp rows, keep bits and w come into the other half of a
// two-stage shared-memory buffer by cp.async while this group is summed.
__global__ void __launch_bounds__(B_THREADS, 2) adm_bwd_stream(
    const float* __restrict__ w, const float* __restrict__ asp,
    const float* __restrict__ g, const uint32_t* __restrict__ bits,
    float* __restrict__ dw, float* __restrict__ dasp, int B, int A, int C,
    float scale) {
  __shared__ __align__(16) float asp_s[2][B_ASP][S_COLS];
  __shared__ uint32_t bits_s[2][B_SUMS][S_COLS / 32];
  __shared__ float ws[2][B_SUMS];
  __shared__ float wpart[B_WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = 4 * threadIdx.x;
  const bool col_ok = c0 < C;
  const int words = (C + 31) / 32;
  const int groups = (A + B_ASP - 1) / B_ASP;

  // stage `st` <- group grp: asp rows, keep bits, w, of the pairs inside
  // B and A (the others are never read with a keep bit set)
  auto fetch = [&](int st, int grp) {
    const int a0 = grp * B_ASP;
    if (col_ok) {
#pragma unroll
      for (int j = 0; j < B_ASP; ++j)
        if (a0 + j < A)
          cp_async16(&asp_s[st][j][c0], asp + (size_t)(a0 + j) * C + c0);
    }
    for (int i = threadIdx.x; i < B_SUMS * (S_COLS / 32); i += B_THREADS) {
      const int pr = i / (S_COLS / 32), wd = i % (S_COLS / 32);
      const int b = pr / B_ASP, a = a0 + pr % B_ASP;
      if (b < B && a < A && wd < words)
        cp_async4(&bits_s[st][pr][wd],
                  bits + ((size_t)b * A + a) * words + wd);
    }
    if (threadIdx.x < B_SUMS) {
      const int b = threadIdx.x / B_ASP, a = a0 + threadIdx.x % B_ASP;
      if (b < B && a < A)
        cp_async4(&ws[st][threadIdx.x], w + (size_t)b * A + a);
    }
    cp_async_commit();
  };

  float gv[B_ROWS][4];
#pragma unroll
  for (int r = 0; r < B_ROWS; ++r) {
    const float4 v = r < B && col_ok
        ? __ldg(reinterpret_cast<const float4*>(g + (size_t)r * C + c0))
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    gv[r][0] = v.x; gv[r][1] = v.y; gv[r][2] = v.z; gv[r][3] = v.w;
  }
  if (blockIdx.x < groups) fetch(0, blockIdx.x);
  for (int grp = blockIdx.x, k = 0; grp < groups; grp += gridDim.x, ++k) {
    const int st = k & 1, a0 = grp * B_ASP;
    if (grp + gridDim.x < groups)
      fetch(st ^ 1, grp + gridDim.x);
    else
      cp_async_commit();                     // an empty group: wait_one holds
    cp_async_wait_one();
    __syncthreads();
    float p[B_SUMS];   // p[r B_ASP + j]: dw of (r, a0 + j)
#pragma unroll
    for (int j = 0; j < B_ASP; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(&asp_s[st][j][c0]);
      const float av[4] = {v.x, v.y, v.z, v.w};
      float da[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < B_ROWS; ++r) {
        const int pr = r * B_ASP + j;
        const uint32_t m = r < B && a0 + j < A && col_ok
            ? bits_s[st][pr][c0 / 32] >> (c0 % 32) : 0u;
        const float wv = ws[st][pr];
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (m & (1u << q)) {
            da[q] = fmaf(gv[r][q], wv, da[q]);
            s = fmaf(gv[r][q], av[q], s);
          }
        }
        p[pr] = s;
      }
      if (col_ok && a0 + j < A)
        *reinterpret_cast<float4*>(dasp + (size_t)(a0 + j) * C + c0) =
            make_float4(da[0] * scale, da[1] * scale, da[2] * scale,
                        da[3] * scale);
    }
    wpart[warp][lane] = reduce_scatter(p, lane);
    __syncthreads();
    if (threadIdx.x < B_SUMS) {
      const int b = threadIdx.x / B_ASP, a = a0 + threadIdx.x % B_ASP;
      if (b < B && a < A) {
        float s = wpart[0][threadIdx.x];
#pragma unroll
        for (int q = 1; q < B_WARPS; ++q) s += wpart[q][threadIdx.x];
        dw[(size_t)b * A + a] = s * scale;
      }
    }
  }
}

}  // namespace

// Returns a CUDA error code (0 on success); launches on `stream`, does not
// synchronise. key: a device pointer to the two key words, each the low
// 32 bits of a 64-bit word (a CUDA graph replays the launch with whatever
// words the caller wrote there before the replay). w and asp hold aspects
// [a_off, a_off + A) of a table of A_total (the whole table: A_total = A,
// a_off = 0); scale is 1 / (A_total keep). `bits` may be null: no keep
// bits are written. `scratch` holds splits x B x CP floats (CP: C rounded
// up to 128), `span` aspects a split, as `aspect_dropout_plan` gives them;
// a plan that does not cover A once, a scratch too small, or a shard
// outside its table, is refused.
extern "C" int aspect_dropout_fwd(const void* w, const void* asp, void* out,
                                  void* bits, void* scratch,
                                  long long scratch_floats, int B, int A,
                                  int C, int A_total, int a_off, int splits,
                                  int span, const void* key, unsigned thr,
                                  float scale, void* stream) {
  if (key == nullptr || B <= 0 || A <= 0 || C <= 0 || span <= 0 ||
      span > F_MAX_SPAN || a_off < 0 || (long long)a_off + A > A_total ||
      splits <= 0 || splits > 65535 || (B + F_ROWS - 1) / F_ROWS > 65535 ||
      (long long)splits * span < A || (long long)(splits - 1) * span >= A)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C + F_COLS - 1) / F_COLS;
  const int cp = tiles * F_COLS;
  if (scratch_floats < (long long)splits * B * cp)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fast = (C & 3) == 0 &&
                    (unsigned long long)B * A_total * (C / 4) <= (1ull << 32);
  const dim3 grid(tiles, splits, (B + F_ROWS - 1) / F_ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* ap = static_cast<const float*>(asp);
  float* pp = static_cast<float*>(scratch);
  uint32_t* bp = static_cast<uint32_t*>(bits);
  const unsigned long long* kp = static_cast<const unsigned long long*>(key);
  if (fast && bp)
    adm_fwd_kernel<true, true><<<grid, F_THREADS, 0, st>>>(
        wp, ap, pp, bp, B, A, C, A_total, a_off, span, kp, thr);
  else if (fast)
    adm_fwd_kernel<true, false><<<grid, F_THREADS, 0, st>>>(
        wp, ap, pp, bp, B, A, C, A_total, a_off, span, kp, thr);
  else if (bp)
    adm_fwd_kernel<false, true><<<grid, F_THREADS, 0, st>>>(
        wp, ap, pp, bp, B, A, C, A_total, a_off, span, kp, thr);
  else
    adm_fwd_kernel<false, false><<<grid, F_THREADS, 0, st>>>(
        wp, ap, pp, bp, B, A, C, A_total, a_off, span, kp, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B * cp + S_THREADS - 1) / S_THREADS);
  cfg.blockDim = dim3(S_THREADS);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, adm_fwd_sum,
                           static_cast<const float*>(scratch),
                           static_cast<float*>(out), B, C, cp, splits, scale);
  return static_cast<int>(err);
}

// dw (B, A) and dasp (A, C) from the keep bits the forward wrote. `blocks`
// > 0 runs that many persistent blocks of the streamed kernel, which takes
// C % 4 == 0, C <= S_COLS and B <= B_ROWS, at most one a group; 0 runs a
// block a group of B_ASP aspects. As `aspect_dropout_plan` gives it; a
// plan the shape does not take is refused.
extern "C" int aspect_dropout_bwd(const void* w, const void* asp,
                                  const void* g, const void* bits, void* dw,
                                  void* dasp, int B, int A, int C, int blocks,
                                  float scale, void* stream) {
  if (B <= 0 || A <= 0 || C <= 0 || blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (A + B_ASP - 1) / B_ASP;
  if (blocks > 0 && ((C & 3) != 0 || C > S_COLS || B > B_ROWS ||
                     blocks > groups))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* ap = static_cast<const float*>(asp);
  const float* gp = static_cast<const float*>(g);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  float* dwp = static_cast<float*>(dw);
  float* dap = static_cast<float*>(dasp);
  if (blocks > 0)
    adm_bwd_stream<<<blocks, B_THREADS, 0, st>>>(wp, ap, gp, bp, dwp, dap, B,
                                                 A, C, scale);
  else
    adm_bwd_kernel<<<groups, B_THREADS, 0, st>>>(wp, ap, gp, bp, dwp, dap, B,
                                                 A, C, scale);
  return static_cast<int>(cudaGetLastError());
}

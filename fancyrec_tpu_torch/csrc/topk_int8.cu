// Fused int8 score + top-k -- the JAX package's Pallas kernel
// `retrieval_topk_fused_int8` (fancyrec_tpu/ops/similarity.py:242, its body
// `_topk_fused_kernel` :184).
//
//   brands (B, D) float32  brand embeddings, quantized here
//   qp     (N, D) int8     posts, quantized per row
//   inv    (N,)   float32  1 / ||qp_j||
//   ->     vals (B, k) float32, idx (B, k) int32, best first
//
// score[b, j] = float(int32 dot(qb[b], qp[j])) * inv[j] for j < n_valid.
// Selection orders by (score descending, index ascending), which is
// lax.top_k's tie rule; the selected scores are then multiplied by the
// brand's scale b_inv[b] = 1 / ||qb[b]||. Slots past the n_valid
// candidates are filler: -inf times the scale, index 0. Any D % 4 == 0.
//
// Bound on an H100 at the serving shape (B=51, N=1,000,000, D=1024, k=10):
// reading the 1.028 GB int8 index once takes 0.307 ms at 3.35 TB/s; the
// 104 G integer operations take 0.05 ms at the int8 tensor-core rate. So it
// is bytes-bound, and the design is about keeping the index streaming.
//
// Design: three launches on the caller's stream, no PyTorch op between.
//   1. `topk_quantize_kernel`, a block a brand row: the same operations as
//      ops.similarity.quantize_rows_int8 on the card, so q is bit-identical
//      (reciprocal of the max-abs as an IEEE division, times 127, round half
//      to even, clip to +-127; b_inv = rsqrtf of the exact sum of squares, 0
//      for an all-zero row). q goes to scratch in rows of round_up(D, 256)
//      bytes, zero-padded. The same block then scores its brand against the
//      first 256 valid posts (2,048 where k > 32; rows up to 38 KB or 24 KB)
//      and leaves their k-th best key as the brand's first threshold, so the
//      partial kernel's first tiles start filtered (the "seed").
//   2. `topk_partial_kernel<KS, V16, BR>`, persistent: about one block an SM
//      (gridDim.x blocks a 64-brand tile). A block walks every gridDim.x-th
//      tile of 128 posts, stage by stage: 128 posts x KS bytes of D through
//      a ring of S = 4..8 slots. Its 64 quantized brands either stay whole
//      in shared memory (BR false, where they fit beside 4 stages), or, for
//      wider D, come through the ring beside the posts, 64 rows x KS bytes a
//      stage from L2 (BR true), so shared memory does not grow with D. A
//      producer warp fills the ring: where rows are whole 16 bytes, one
//      thread issues tensor-map copies (TMA) of 128 post rows (and 64 brand
//      rows) x min(KS, 128) bytes into swizzled slots, completing on the
//      slot's mbarrier; else the warp issues 4-byte cp.async copies of the
//      posts (16-byte ones of the brands) into padded rows. Eight consumer
//      warps wait on a slot's barrier, multiply, and free the slot on a
//      second barrier before the tile's epilogue, so the ring keeps
//      streaming through it; no block barrier is taken in the loop. At the
//      serving shape: KS = 256, S = 4, 204,672 bytes of shared memory, 3 x
//      32 KB = 96 KB in flight an SM (about 25 KB is what 3.35 TB/s needs at
//      a microsecond of latency). The tensor map streams faster than 16-byte
//      cp.async copies by every thread with a block barrier a stage, and
//      than a 1-D bulk copy a row (too many small copies). The swizzle (and
//      the padding of the other layout and of the brand rows) puts the
//      eight rows an `ldmatrix` phase reads in distinct bank groups.
//      Products are `mma.sync` m16n8k32 s8 x s8 -> s32 (exact), fed by
//      `ldmatrix`: each consumer warp owns 32 brands x 32 posts of a tile.
//      The products are a sixth of the bytes bound, so the synchronous mma
//      was kept over wgmma, whose shared-memory layouts are the riskier
//      code.
//      Epilogue in registers: a score is scaled by inv and compared with
//      its brand's threshold, the larger of its list's k-th key and a
//      threshold across blocks: first the seed, then, for k <= 32, the k-th
//      largest of the blocks' best keys of the brand (each block publishes
//      its lists' best with a 64-bit atomicMax; one warp a tile refreshes
//      one of its eight brands). Any k distinct
//      posts bound the k-th best from below, so a post under a threshold is
//      not in the top k. Posts at or past n_valid score NaN and never pass.
//      Only rows with survivors take the slow path: the warp gathers the
//      row's 32 scores from the quad of lanes that holds them, one a lane,
//      and merges them into the brand's sorted list in shared memory by
//      rank, under a per-brand lock (four warps share a brand). Once the
//      blocks' best keys are in, a post must beat about the k-th best of
//      all the posts the card has seen, and almost nothing survives.
//      A candidate is one 64-bit key, (order-preserving bits of the score)
//      << 32 | (~index): a larger key is a larger score, or the same score at
//      a smaller index. Keys are unique, so the lists, and the result, do
//      not depend on the order in which blocks or warps insert; key 0 is the
//      filler below every post. Each block writes its lists: (B, grid, k).
//   3. `topk_merge_kernel`, a block a brand, launched with programmatic
//      dependent launch: k rounds of a block-wide max over the candidates,
//      then the brand scale and the filler.
// The partial kernel is launched with programmatic dependent launch too: its
// producer warp starts the ring while the consumers wait for the quantized
// brands.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The two filters across blocks, which a build may switch off to time what
// each saves (kernel_ab.py): the seed thresholds of the quantization kernel
// (0: none), and the refresh of thresholds from the blocks' best keys (0:
// never).
#ifndef TOPK_SEED
#define TOPK_SEED 1
#endif
#ifndef TOPK_REFRESH
#define TOPK_REFRESH 1
#endif

namespace {

constexpr int TB = 64;            // brands a block
constexpr int TP = 128;           // posts a tile
constexpr int CONSUMERS = 256;    // 8 warps: 2 brand halves x 4 post quarters
constexpr int THREADS = CONSUMERS + 32;   // and a producer warp
constexpr int PAD = 16;           // bytes after each shared row
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of an H100 block
constexpr int MIN_STAGES = 4, MAX_STAGES = 8;
constexpr int QUANT_THREADS = 256;
constexpr int MAX_BEST = 8;       // best keys a lane reads: 256 blocks
constexpr int MERGE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// bytes of a quantized brand row in scratch: whole stages of the widest
// ring stage, zero past D
__host__ __device__ constexpr int qb_stride(int D) { return round_up(D, 256); }

// bytes of D a tensor-map box spans, the width of its swizzle
__host__ __device__ constexpr int box_bytes(int ks) { return ks < 128 ? ks : 128; }

// bytes of a row in a ring slot: unpadded in the tensor map's swizzled
// boxes (rows of whole 16 bytes), else padded
__host__ __device__ constexpr int row_bytes(int ks, bool v16) {
  return v16 ? ks : ks + PAD;
}

// a ring slot: TP post rows of KS bytes, and with the brands in the ring
// (br) TB brand rows after them
__host__ __device__ constexpr int slot_bytes(int ks, bool v16, bool br) {
  return (TP + (br ? TB : 0)) * row_bytes(ks, v16);
}

// dynamic shared memory of the partial kernel: the ring's barriers, lists,
// thresholds, locks, the brands (unless they come through the ring), the
// ring (aligned to 1024 bytes for the swizzle)
__host__ __device__ constexpr size_t partial_smem(int D, int k, int ks,
                                                  int stages, bool br) {
  return 16 * MAX_STAGES + (size_t)TB * k * 8 + TB * 8 + TB * 4 +
         (br ? 0 : (size_t)TB * (round_up(D, ks) + PAD)) +
         (D % 16 == 0 ? 1024 : 0) +
         (size_t)stages * slot_bytes(ks, D % 16 == 0, br);
}

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

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a 4-byte copy into shared memory
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

// a 16-byte copy into shared memory, through L2 only
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src) : "memory");
}

// the calling thread's earlier cp.async copies arrive on `bar` when done
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar) : "memory");
}

// a 2-D tensor copy (TMA) of the box at (column c0 bytes, row c1) into
// shared memory, completing on `bar`; rows past the tensor are zeros
__device__ __forceinline__ void tensor_copy(unsigned dst, const CUtensorMap* map,
                                            int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes) : "memory");
}

// wait for the phase of `parity` to complete; a trap, not a hang, if it
// never does
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (long n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (n > (1l << 26)) __trap();
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, int& r0, int& r1,
                                        int& r2, int& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// D (16 x 8, s32) += A (16 x 32, s8, row) * B (32 x 8, s8, col), exact
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// 1. the brands' quantization, and each brand's first threshold

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(FULL, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// the largest of the block's values below `last`, to every thread
__device__ __forceinline__ u64 block_max_below(u64 v, u64* part) {
  v = warp_max(v);
  __syncthreads();                       // part[] is free again
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  u64 m = 0ull;
#pragma unroll
  for (int w = 0; w < QUANT_THREADS / 32; ++w) m = part[w] > m ? part[w] : m;
  return m;
}

// A block a brand row. Then the brand's key against the first NSEED valid
// posts (none for 0), the same scores the partial kernel computes, and
// their k-th largest as the brand's first threshold across blocks (the
// seed): at least k posts reach it, so a post below it is not in the top
// k, and the first tile of every block need not merge all its scores. The
// seed takes dynamic shared memory: the brand's q row and NSEED keys.
// NSEED is a template parameter: a run-time flag there timed slower.
template <int NSEED>
__global__ void __launch_bounds__(QUANT_THREADS) topk_quantize_kernel(
    const float* __restrict__ brands, const int8_t* __restrict__ qp,
    const float* __restrict__ inv, int8_t* __restrict__ qb,
    float* __restrict__ b_inv, u64* __restrict__ seed,
    u64* __restrict__ best, int D, int n_valid, int k, int grid) {
  asm volatile("griddepcontrol.launch_dependents;");
  for (int i = threadIdx.x; i < grid; i += QUANT_THREADS)
    best[(size_t)blockIdx.x * grid + i] = 0ull;
  const int dq = qb_stride(D);
  extern __shared__ __align__(16) unsigned char qsm[];   // where seeding
  int8_t* qs = reinterpret_cast<int8_t*>(qsm);                 // [dq]
  u64* keys = reinterpret_cast<u64*>(qsm + dq);                 // [NSEED]
  __shared__ float wmax[QUANT_THREADS / 32];
  __shared__ int wsum[QUANT_THREADS / 32];
  __shared__ u64 part[QUANT_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = brands + (size_t)blockIdx.x * D;
  float m = 0.0f;
  for (int d = tid; d < D; d += QUANT_THREADS) m = fmaxf(m, fabsf(row[d]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  float amax = 0.0f;
#pragma unroll
  for (int w = 0; w < QUANT_THREADS / 32; ++w) amax = fmaxf(amax, wmax[w]);
  // torch's 127.0 / amax: the reciprocal, then times 127
  const float scale =
      amax > 0.0f ? __fmul_rn(__fdiv_rn(1.0f, amax), 127.0f) : 0.0f;
  int8_t* qrow = qb + (size_t)blockIdx.x * dq;
  int sq = 0;
  for (int d = tid; d < dq; d += QUANT_THREADS) {
    int q = 0;
    if (d < D) {
      q = max(-127, min(127, __float2int_rn(__fmul_rn(row[d], scale))));
      sq += q * q;
    }
    qrow[d] = static_cast<int8_t>(q);
    if constexpr (NSEED > 0) qs[d] = static_cast<int8_t>(q);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(FULL, sq, off);
  if (lane == 0) wsum[warp] = sq;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < QUANT_THREADS / 32; ++w) total += wsum[w];
    // the float32 sum of the squares is this integer (exact below 2^24;
    // past it, torch's float sum may round where this does not)
    b_inv[blockIdx.x] = total > 0 ? rsqrtf(static_cast<float>(total)) : 0.0f;
  }

  const int n_seed = min(n_valid, NSEED);
  if (n_seed < k) {                      // fewer posts than k: no threshold
    if (tid == 0) seed[blockIdx.x] = 0ull;
    return;
  }
  // a warp a post: exact int32 dots in 4-byte words
  const int* qw = reinterpret_cast<const int*>(qs);
  for (int j = warp; j < n_seed; j += QUANT_THREADS / 32) {
    const int* pw = reinterpret_cast<const int*>(qp + (size_t)j * D);
    int dot = 0;
    for (int c = lane; c < D / 4; c += 32) dot = __dp4a(pw[c], qw[c], dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(FULL, dot, off);
    if (lane == 0) keys[j] = make_key(static_cast<float>(dot) * inv[j], j);
  }
  __syncthreads();
  u64 last = ~0ull;                      // keys are unique: the next below
  for (int r = 0; r < k; ++r) {
    u64 v = 0ull;
    for (int j = tid; j < n_seed; j += QUANT_THREADS)
      if (keys[j] < last && keys[j] > v) v = keys[j];
    last = block_max_below(v, part);
  }
  if (tid == 0) seed[blockIdx.x] = last;
}

// ---------------------------------------------------------------------------
// 2. the partial top-k lists

// merge up to 32 candidate keys, one a lane (0 for none), into a brand's
// sorted list (descending, k entries), under the brand's lock; the whole
// warp takes part. Each element's new place is its rank in the union: the
// keys are unique, so the ranks are a permutation and every place below k
// is written once. After the lock, the list's best key is offered as this
// block's best of the brand.
__device__ __forceinline__ void list_merge(u64* list, int* lock,
                                           u64* __restrict__ best, u64 cand,
                                           int k, int lane) {
  volatile u64* L = list;
  if (lane == 0) {
    while (atomicCAS(lock, 0, 1) != 0) {
    }
    __threadfence_block();
  }
  __syncwarp();
  if (cand <= L[k - 1]) cand = 0ull;     // the list moved on
  unsigned live = __ballot_sync(FULL, cand != 0ull);
  if (live) {
    u64 e[4];
    int re[4];                           // candidates above each entry
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = lane + 32 * q;
      e[q] = (32 * q < k && i < k) ? L[i] : 0ull;
      re[q] = 0;
    }
    int rank = 0;                        // the candidate's place
    while (live) {                       // each candidate against all
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const u64 c = __shfl_sync(FULL, cand, src);
      rank += c > cand;
      int above = 0;                     // list entries above c
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        re[q] += c > e[q];
        if (32 * q < k) above += __popc(__ballot_sync(FULL, e[q] > c));
      }
      if (lane == src) rank += above;
    }
    __syncwarp();                        // every lane has read the list
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = lane + 32 * q;
      if (32 * q < k && i < k && i + re[q] < k) L[i + re[q]] = e[q];
    }
    if (cand && rank < k) L[rank] = cand;
  }
  __threadfence_block();
  __syncwarp();
  if (lane == 0) {
    const u64 top = L[0];
    atomicExch(lock, 0);
    if (top) atomicMax(best, top);
  }
}

// the producer warp: stage s (tile s / spt, D bytes (s % spt) * KS ..) of
// this block into ring slot s % stages once the consumers have freed it,
// with the same bytes of D of the block's 64 quantized brands after the
// posts where they come through the ring (BR).
// Rows of whole 16 bytes: tensor-map copies of 128 post rows (64 brand
// rows) x box_bytes(KS), swizzled, one thread issuing; rows past n_valid
// (past B) and bytes past D arrive as zeros. Else the warp's 4-byte
// cp.async copies of the posts (16-byte ones of the zero-padded brand
// rows) into padded rows; rows past n_valid or B are not copied (their
// scores are masked) and post bytes past D meet zero brand bytes.
template <int KS, bool V16, bool BR>
__device__ __forceinline__ void produce(const CUtensorMap* map,
                                        const CUtensorMap* bmap,
                                        const int8_t* __restrict__ qp,
                                        const int8_t* __restrict__ qb,
                                        unsigned ring_s, unsigned full_s,
                                        unsigned empty_s, int total, int spt,
                                        int B, int b0, int D, int n_valid,
                                        int stages, int lane) {
  constexpr int BOX = box_bytes(KS), RB = row_bytes(KS, V16);
  if constexpr (BR)     // the brands come from the quantization kernel
    asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int s = 0; s < total; ++s) {
    const int slot = s % stages;
    if (s >= stages) mbar_wait(empty_s + 8 * slot, (s / stages - 1) & 1);
    const int tile = blockIdx.x + (s / spt) * gridDim.x;
    const int d0 = (s % spt) * KS;
    const unsigned dst = ring_s + slot * slot_bytes(KS, V16, BR);
    const unsigned bar = full_s + 8 * slot;
    if constexpr (V16) {
      if (lane == 0) {
        mbar_expect_tx(bar, (TP + (BR ? TB : 0)) * KS);
#pragma unroll
        for (int b = 0; b < KS / BOX; ++b)
          tensor_copy(dst + b * TP * BOX, map, d0 + b * BOX, tile * TP, bar);
        if constexpr (BR) {
#pragma unroll
          for (int b = 0; b < KS / BOX; ++b)
            tensor_copy(dst + TP * KS + b * TB * BOX, bmap, d0 + b * BOX, b0,
                        bar);
        }
      }
    } else {
      const int rows = min(TP, n_valid - tile * TP);
      const int words = min(KS, D - d0) / 4;
      const int8_t* src = qp + (size_t)tile * TP * D + d0;
      for (int e = lane; e < rows * words; e += 32)
        cp_async4(dst + (e / words) * RB + 4 * (e % words),
                  src + (size_t)(e / words) * D + 4 * (e % words));
      if constexpr (BR) {
        constexpr int CPR = KS / 16;       // 16-byte chunks a brand row
        const int dq = qb_stride(D);
        const int8_t* bsrc = qb + (size_t)b0 * dq + d0;
        for (int e = lane; e < min(TB, B - b0) * CPR; e += 32)
          cp_async16(dst + (TP + e / CPR) * RB + 16 * (e % CPR),
                     bsrc + (size_t)(e / CPR) * dq + 16 * (e % CPR));
      }
      cp_async_arrive(bar);
    }
  }
}

// where byte kb of row `row` of a region of ROWS rows of a ring slot lies:
// in box kb / BOX, and for the tensor-map layout through the swizzle
// (16-byte chunk c of a 128-byte line l moves to c ^ (l mod 8), narrowed to
// the box's width)
template <int KS, bool V16, int ROWS>
__device__ __forceinline__ unsigned slot_off(int row, int kb) {
  if constexpr (V16) {
    constexpr int BOX = box_bytes(KS);
    const unsigned off = (kb / BOX) * ROWS * BOX + row * BOX + kb % BOX;
    return off ^ (((off >> 7) & (BOX / 16 - 1)) << 4);
  } else {
    return row * (KS + PAD) + kb;
  }
}

// the consumer warps (8): products of each ring stage against the brands
// (in shared memory at bs_s, rows of BSTR bytes, or in the slot after its
// posts: BR), and each tile's epilogue. Warp (wm, wn) owns brands 32 wm..
// and posts 32 wn.. of a tile.
template <int KS, bool V16, bool BR>
__device__ __forceinline__ void consume(
    unsigned bs_s, unsigned ring_s, unsigned full_s, unsigned empty_s,
    u64* lists, volatile u64* thr, int* locks, const float* __restrict__ inv,
    u64* best, int B, int b0, int n_valid, int k, int stages, int total,
    int spt, int BSTR, bool refresh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int wm = warp & 1, wn = warp >> 1;
  // a brand's threshold across blocks, refreshed (`refresh`, see
  // refreshes()) by each warp for one of its eight brand rows halfway
  // through a tile (every tile for the first eight, then every other):
  // about the k-th largest of the blocks' best keys (k blocks hold a post
  // at least that good); the loads are issued as the tile starts.
  u64 bv[MAX_BEST];
  // ldmatrix row addresses: lane l serves row l % 8 of matrix l / 8
  const int mt = lane >> 3, rr = lane & 7;
  const int a_row = 32 * wm + (mt & 1) * 8 + rr;        // + 16 mi
  const unsigned a_base = bs_s + a_row * BSTR + (mt >> 1) * 16;
  const int b_row = 32 * wn + (mt >> 1) * 8 + rr;   // + 16 np
  const float nan = __uint_as_float(0x7fffffffu);

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0;
  float iv[4][2];

  for (int s = 0; s < total; ++s) {
    const int j = s % spt;
    const int p0 = (blockIdx.x + (s / spt) * gridDim.x) * TP;
    if (j == 0) {
      // the epilogue's inverse norms, in flight during the tile's stages
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int p = p0 + 32 * wn + 8 * nj + 2 * t + cc;
          iv[nj][cc] = p < n_valid ? __ldg(inv + p) : nan;
        }
      const int tix = s / spt;
      const int rb = b0 + 8 * warp + (tix < 8 ? tix : tix >> 1) % 8;
#pragma unroll
      for (int x = 0; x < MAX_BEST; ++x) {
        const int i = lane + 32 * x;
        bv[x] = refresh && rb < B && i < static_cast<int>(gridDim.x)
            ? __ldcg(best + (size_t)rb * gridDim.x + i) : 0ull;
      }
    }
    const int tix = s / spt;             // this block's tile count so far
    if (refresh && j == spt / 2 && (tix < 8 || (tix & 1))) {
      // the k-th largest of the lanes' best score words, by a bitonic sort
      // across the warp: k lanes hold a block's best key at least as high
      unsigned m = 0;
#pragma unroll
      for (int x = 0; x < MAX_BEST; ++x)
        m = max(m, static_cast<unsigned>(bv[x] >> 32));
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
        for (int stride = size / 2; stride > 0; stride >>= 1) {
          const unsigned o = __shfl_xor_sync(FULL, m, stride);
          m = (((lane & size) == 0) == ((lane & stride) == 0)) ? min(m, o)
                                                               : max(m, o);
        }
      const u64 top = static_cast<u64>(__shfl_sync(FULL, m, 32 - k)) << 32;
      const int rb = 8 * warp + (tix < 8 ? tix : tix >> 1) % 8;
      if (lane == 0 && top > thr[rb]) thr[rb] = top;
    }
    float ts[4];          // the score a post must reach in each of 4 rows
    if (j == spt - 1) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = 32 * wm + 16 * (x >> 1) + 8 * (x & 1) + g;
        u64 kth = reinterpret_cast<volatile u64*>(lists)[r * k + k - 1];
        kth = thr[r] > kth ? thr[r] : kth;
        ts[x] = b0 + r >= B ? __uint_as_float(0x7f800000u)
                            : kth ? key_score(kth) : neg_inf();
      }
    }
    const unsigned a_addr = a_base + j * KS;
    const unsigned slot = ring_s + (s % stages) * slot_bytes(KS, V16, BR);
    mbar_wait(full_s + 8 * (s % stages), (s / stages) & 1);
#pragma unroll
    for (int kk = 0; kk < KS / 32; ++kk) {
      int a[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(BR ? slot + TP * row_bytes(KS, V16) +
                         slot_off<KS, V16, TB>(a_row + 16 * mi,
                                               kk * 32 + (mt >> 1) * 16)
                   : a_addr + mi * 16 * BSTR + kk * 32,
                a[mi][0], a[mi][1], a[mi][2], a[mi][3]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(slot + slot_off<KS, V16, TP>(b_row + 16 * np,
                                             kk * 32 + (mt & 1) * 16),
                bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0],
                bf[2 * np + 1][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_s8(acc[mi][nj], a[mi], bf[nj][0], bf[nj][1]);
    }
    __syncwarp();                    // the warp has read the slot
    if (lane == 0) mbar_arrive(empty_s + 8 * (s % stages));
    if (j != spt - 1) continue;

    // epilogue: acc[mi][nj][c] is brand 32 wm + 16 mi + g + 8 (c / 2) and
    // post p0 + 32 wn + 8 nj + 2 t + c % 2
    float sc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[mi][nj][c] = static_cast<float>(acc[mi][nj][c]) * iv[nj][c & 1];
          acc[mi][nj][c] = 0;
        }
    // a brand's threshold: its list's k-th key, or its threshold across
    // blocks, read before this stage's products
    unsigned pend = 0;    // bit (2 mi + h) * 8 + 2 nj + cc: may enter a list
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            if (sc[mi][nj][2 * h + cc] >= ts[2 * mi + h])
              pend |= 1u << ((2 * mi + h) * 8 + 2 * nj + cc);
    if (!__any_sync(FULL, pend != 0)) continue;
    // a brand row at a time: its quad's 32 scores, one a lane, merge into
    // its list. Warps sharing the rows start at different quads.
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const int mi = sl >> 1, h = sl & 1;
      const unsigned bits = (pend >> (8 * sl)) & 0xffu;
      const unsigned lanes = __ballot_sync(FULL, bits != 0u);
      unsigned quads = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if ((lanes >> (4 * q)) & 0xfu) quads |= 1u << q;
      const int start = (2 * wn) & 7;
      quads = ((quads >> start) | (quads << (8 - start))) & 0xffu;
      while (quads) {
        const int qd = (__ffs(quads) - 1 + start) & 7;
        quads &= quads - 1;
        const int src = 4 * qd + (lane >> 3), q = lane & 7;
        const unsigned sbits = __shfl_sync(FULL, bits, src);
        float v = 0.0f;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float w = __shfl_sync(FULL, sc[mi][x >> 1][2 * h + (x & 1)],
                                      src);
          if (x == q) v = w;
        }
        const u64 key = ((sbits >> q) & 1u)
            ? make_key(v, p0 + 32 * wn + 8 * (q >> 1) + 2 * (lane >> 3) +
                              (q & 1))
            : 0ull;
        const int r = 32 * wm + 16 * mi + 8 * h + qd;
        list_merge(lists + (size_t)r * k, locks + r,
                   best + (size_t)(b0 + r) * gridDim.x + blockIdx.x, key, k,
                   lane);
      }
    }
  }
}

template <int KS, bool V16, bool BR>
__global__ void __launch_bounds__(THREADS, 1) topk_partial_kernel(
    const __grid_constant__ CUtensorMap map,
    const __grid_constant__ CUtensorMap bmap, const int8_t* __restrict__ qb,
    const int8_t* __restrict__ qp,
    const float* __restrict__ inv, const u64* __restrict__ seed, u64* best,
    u64* __restrict__ cand, int B, int D, int n_valid, int k, int stages,
    int refresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DS = round_up(D, KS);              // D in whole stages
  const int BSTR = DS + PAD;
  u64* lists = reinterpret_cast<u64*>(smem + 16 * MAX_STAGES);     // [TB][k]
  volatile u64* thr = lists + TB * k;                              // [TB]
  int* locks = reinterpret_cast<int*>(lists + TB * k + TB);        // [TB]
  // the brands, [TB][BSTR], unless they come through the ring
  unsigned char* bs = reinterpret_cast<unsigned char*>(locks + TB);
  const unsigned bs_s = smem_u32(bs);
  const unsigned bs_end = bs_s + (BR ? 0 : TB * BSTR);
  const unsigned ring_s = V16 ? (bs_end + 1023) / 1024 * 1024 : bs_end;

  const unsigned full_s = smem_u32(smem);                          // [S]
  const unsigned empty_s = full_s + 8 * MAX_STAGES;                // [S]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.y * TB;
  const int spt = DS / KS;                     // stages a tile
  const int n_tiles = (n_valid + TP - 1) / TP;
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
      ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int total = my_tiles * spt;            // this block's stages

  asm volatile("griddepcontrol.launch_dependents;");
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full_s + 8 * i, V16 ? 1 : 32);
      mbar_init(empty_s + 8 * i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int e = tid; e < TB * k; e += THREADS) lists[e] = 0ull;
  if (tid < TB) locks[tid] = 0;
  __syncthreads();
  if (warp == CONSUMERS / 32) {
    // the posts do not depend on the quantization: the ring starts at once
    produce<KS, V16, BR>(&map, &bmap, qp, qb, ring_s, full_s, empty_s,
                         total, spt, B, b0, D, n_valid, stages, lane);
  } else {
    asm volatile("griddepcontrol.wait;" ::: "memory");   // quantized brands
    const int dq = qb_stride(D), cpr = DS / 16;
    for (int e = tid; !BR && e < TB * cpr; e += CONSUMERS) {
      const int r = e / cpr, c = e % cpr;
      int4 v = make_int4(0, 0, 0, 0);
      if (b0 + r < B)
        v = *reinterpret_cast<const int4*>(qb + (size_t)(b0 + r) * dq + 16 * c);
      *reinterpret_cast<int4*>(bs + r * BSTR + 16 * c) = v;
    }
    if (tid < TB) thr[tid] = b0 + tid < B ? seed[b0 + tid] : 0ull;
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    consume<KS, V16, BR>(bs_s, ring_s, full_s, empty_s, lists, thr, locks,
                         inv, best, B, b0, n_valid, k, stages, total, spt,
                         BSTR, refresh != 0);
  }
  __syncthreads();
  for (int e = tid; e < TB * k; e += THREADS) {
    const int r = e / k, s = e % k;
    if (b0 + r < B)
      cand[((size_t)(b0 + r) * gridDim.x + blockIdx.x) * k + s] = lists[e];
  }
}

// ---------------------------------------------------------------------------
// 3. the merge

__global__ void __launch_bounds__(MERGE_THREADS) topk_merge_kernel(
    const u64* __restrict__ cand, const float* __restrict__ b_inv,
    float* __restrict__ vals, int* __restrict__ idx, int n_cand, int k) {
  __shared__ u64 part[MERGE_THREADS / 32];
  __shared__ u64 best;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the lists
  const int b = blockIdx.x;
  const u64* c = cand + (size_t)b * n_cand;
  const float scale = b_inv[b];
  u64 last = ~0ull;                     // keys are unique: take the next below
  for (int s = 0; s < k; ++s) {
    u64 m = 0ull;
    for (int e = threadIdx.x; e < n_cand; e += MERGE_THREADS) {
      const u64 v = c[e];
      if (v < last && v > m) m = v;
    }
    m = warp_max(m);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      u64 v = threadIdx.x < MERGE_THREADS / 32 ? part[threadIdx.x] : 0ull;
      v = warp_max(v);
      if (threadIdx.x == 0) best = v;
    }
    __syncthreads();
    const u64 key = best;
    if (threadIdx.x == 0) {           // filler: -inf times the scale, index 0
      vals[(size_t)b * k + s] =
          __fmul_rn(key ? key_score(key) : neg_inf(), scale);
      idx[(size_t)b * k + s] = key ? key_index(key) : 0;
    }
    last = key ? key : 1ull;            // after the filler only filler is left
    __syncthreads();
  }
}

template <int KS, bool V16, bool BR>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t s,
                           const cudaLaunchAttribute* attr,
                           const CUtensorMap& map, const CUtensorMap& bmap,
                           const int8_t* qb, const int8_t* qp,
                           const float* inv, const u64* seed, u64* best,
                           u64* cand, int B, int D, int n_valid, int k,
                           int stages, int refresh) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<KS, V16, BR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = const_cast<cudaLaunchAttribute*>(attr);
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, topk_partial_kernel<KS, V16, BR>, map, bmap,
                            qb, qp, inv, seed, best, cand, B, D, n_valid, k,
                            stages, refresh);
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint),
// so the library links against the CUDA runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D byte tensor (rows x cols, rows `stride` bytes apart) copied in
// boxes of box_rows x box_cols bytes, swizzled to the box's width; rows past
// `rows` arrive as zeros
bool encode_map(CUtensorMap* map, const void* base, int cols, int rows,
                int stride, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box_cols),
                               static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                dims, strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the partial kernel refreshes its thresholds from the blocks' best
// keys: where k <= 32 and there are k blocks (at most 32 x MAX_BEST)
bool refreshes(int k, int grid) {
  return TOPK_REFRESH && k <= 32 && grid >= k && grid <= 32 * MAX_BEST;
}

// the posts the quantization kernel scores for a brand's seed: few where
// the partial kernel refreshes its thresholds (the seed then only starts
// them), many where the seed is the only threshold across blocks; none
// where the brand's q row (dq bytes) and the keys would not fit 40 KB of
// the 48 KB of shared memory a block may take without opting in.
// (kernel_ab.py at 51 brands, D = 1024: at k = 10, 256 matched 512 over
// 1M posts, beat it over 4,080, and beat 1,024 and 2,048 over both; at k =
// 128, 2,048 beat 256 to 1,024.)
int seed_posts(bool refresh, int dq) {
  const int n = !TOPK_SEED ? 0 : refresh ? 256 : 2048;
  return dq + n * 8 <= 40960 ? n : 0;
}

template <int NSEED>
void launch_quantize(int B, cudaStream_t s, const float* brands,
                     const int8_t* qp, const float* inv, int8_t* qb,
                     float* b_inv, u64* seed, u64* best, int D, int n_valid,
                     int k, int grid) {
  topk_quantize_kernel<NSEED>
      <<<B, QUANT_THREADS, NSEED ? qb_stride(D) + NSEED * sizeof(u64) : 0,
         s>>>(brands, qp, inv, qb, b_inv, seed, best, D, n_valid, k, grid);
}

}  // namespace

// brands (B, D) float32, qp (N, D) int8 with rows 16-byte aligned where
// D % 16 == 0 (else 4-byte), inv (N,) float32, all contiguous; vals (B, k)
// float32 and idx (B, k) int32 out; 1 <= k <= 128, D % 4 == 0; n_valid <= N
// posts rank. The caller's plan (ops.similarity.topk_int8_plan): `grid`
// blocks a 64-brand tile, `ks` bytes of D a ring stage (256 or 128 with the
// brands in shared memory, 128 with them in the ring: `ring_brands`) and
// `stages` (4..8) ring stages, which must fit shared memory; and the
// scratch, scratch_bytes long, with its parts at the 16-byte offsets
// `parts`: q (B, round_up(D, 256)) int8, b_inv (B,) float32, the first
// thresholds (B,), each block's best key of each brand (B, grid) and the
// blocks' lists (B, grid, k), 64-bit keys. Returns 0 on success, else a
// CUDA error code (cudaErrorInvalidValue for arguments it does not take,
// parts that overlap or are not on 16 bytes included;
// cudaErrorMisalignedAddress for qp or the scratch). Launches on `stream`,
// does not synchronise.
extern "C" int topk_int8_fwd(const void* brands, const void* qp,
                             const void* inv, void* scratch,
                             size_t scratch_bytes, const long long* parts,
                             void* vals, void* idx, int B, int D, int n_valid,
                             int k, int grid, int ks, int stages,
                             int ring_brands, void* stream) {
  const bool br = ring_brands != 0;
  if (B < 1 || D < 4 || D % 4 || k < 1 || k > 128 || n_valid < 0 ||
      grid < 1 || stages < MIN_STAGES || stages > MAX_STAGES ||
      (br ? ks != 128 : ks != 128 && ks != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = partial_smem(D, k, ks, stages, br);
  if (smem > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // the parts in order, each on 16 bytes, each before the next
  const size_t sizes[5] = {(size_t)B * qb_stride(D), (size_t)B * 4,
                           (size_t)B * 8, (size_t)B * grid * 8,
                           (size_t)B * grid * k * 8};
  for (int i = 0; i < 5; ++i) {
    const size_t end = i < 4 ? static_cast<size_t>(parts[i + 1])
                             : scratch_bytes;
    if (parts[i] < 0 || parts[i] % 16 || (i < 4 && parts[i + 1] < 0) ||
        static_cast<size_t>(parts[i]) + sizes[i] > end)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool v16 = D % 16 == 0;
  if (reinterpret_cast<uintptr_t>(qp) % (v16 ? 16 : 4) ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int8_t* qb = reinterpret_cast<int8_t*>(base + parts[0]);
  float* b_inv = reinterpret_cast<float*>(base + parts[1]);
  u64* seed = reinterpret_cast<u64*>(base + parts[2]);
  u64* best = reinterpret_cast<u64*>(base + parts[3]);
  u64* cand = reinterpret_cast<u64*>(base + parts[4]);
  const int8_t* p = static_cast<const int8_t*>(qp);
  const float* iv = static_cast<const float*>(inv);
  const int refresh = refreshes(k, grid);
  const float* bf = static_cast<const float*>(brands);
  switch (seed_posts(refresh, qb_stride(D))) {
    case 256: launch_quantize<256>(B, s, bf, p, iv, qb, b_inv, seed, best, D, n_valid, k, grid); break;
    case 2048: launch_quantize<2048>(B, s, bf, p, iv, qb, b_inv, seed, best, D, n_valid, k, grid); break;
    default: launch_quantize<0>(B, s, bf, p, iv, qb, b_inv, seed, best, D, n_valid, k, grid); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the posts as a (n_valid, D) byte tensor, and the quantized brands as a
  // (B, round_up(D, 256)) one, copied in boxes of 128 (64) rows x
  // box_bytes(ks), swizzled
  CUtensorMap map = {}, bmap = {};
  if (v16 && n_valid > 0) {
    if (!encode_map(&map, qp, D, n_valid, D, box_bytes(ks), TP) ||
        (br && !encode_map(&bmap, qb, qb_stride(D), B, qb_stride(D),
                           box_bytes(ks), TB)))
      return static_cast<int>(encode_tiled() ? cudaErrorInvalidValue
                                             : cudaErrorNotSupported);
  }

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  const dim3 g2(grid, (B + TB - 1) / TB);
#define TOPK_LAUNCH(KS, V16, BR)                                             \
  launch_partial<KS, V16, BR>(g2, smem, s, &attr, map, bmap, qb, p, iv, seed, \
                              best, cand, B, D, n_valid, k, stages, refresh)
  if (br)
    err = v16 ? TOPK_LAUNCH(128, true, true) : TOPK_LAUNCH(128, false, true);
  else if (ks == 256)
    err = v16 ? TOPK_LAUNCH(256, true, false) : TOPK_LAUNCH(256, false, false);
  else
    err = v16 ? TOPK_LAUNCH(128, true, false) : TOPK_LAUNCH(128, false, false);
#undef TOPK_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const u64* cc = cand;
  const float* bi = b_inv;
  err = cudaLaunchKernelEx(&cfg, topk_merge_kernel, cc, bi,
                           static_cast<float*>(vals), static_cast<int*>(idx),
                           grid * k, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a): the
// rectangular kernels and the band kernels (causal, or causal with a sliding
// window, with native grouped-query heads).
//
// Replaces six TPU kernels of accelerate_tpu/ops/flash_attention.py:
//   - flash_fwd_kernel      <- `_fwd_kernel`      (launched by `_fwd` through pl.pallas_call)
//   - flash_dq_kernel       <- `_dq_kernel`       (launched by `_bwd`)
//   - flash_dkv_kernel      <- `_dkv_kernel`      (launched by `_bwd`)
//   - flash_band_fwd_kernel <- `_fwd_band_kernel` (launched by `_fwd_band`)
//   - flash_band_dq_kernel  <- `_dq_band_kernel`  (launched by `_bwd_band`)
//   - flash_band_dkv_kernel <- `_dkv_band_kernel` (launched by `_bwd_band`)
// Both families run the same tile bodies (bf16: fwd_tile_sm90, dq_tile_sm90,
// dkv_tile_sm90; fp32: fwd_tile, dq_tile, dkv_tile) under a `Mask` that
// says which (query i, key j) pairs attend:
//   - rectangular: all pairs, or keys j <= i when causal; K/V at the query
//     head count (the wrapper repeats GQA heads, as the reference does); sq
//     and skv may differ;
//   - band: causal self-attention, keys in (i - W, i] under a window W, or
//     j <= i without one (the reference's `_band_logits` rule); K/V in
//     kv-head shape [b*hkv, s, D], read from kv head h / groups in place.
// The mask's family and causality are template flags, so the rectangular
// kernels compile to fixed loop bounds, with no window or group arithmetic.
//
// Layout: q, o, dO, dq are contiguous [b*hq, sq, D]; k, v, dk, dv are
// [b*hkv, skv, D] (hkv = hq for the rectangular kernels); lse and delta are
// fp32 [b*hq, sq]. D is 64 or 128.
//
// What differs from the TPU kernels: on the TPU the kv (or q) axis is the last,
// sequential grid dimension and the running state lives in VMEM scratch across
// grid steps; the band kernels linearise the band into that axis through
// scalar-prefetched maps (row-major for the forward and dQ, column-major over
// (q head in group, q tile) for dK/dV). Here a CTA owns a (b*hq, q tile)
// (forward, dQ) or a (b*hkv, kv tile) (dK/dV) and loops over the other axis
// itself, with its own loop bounds (`Mask`):
//   - forward and dQ: kv tiles from the first inside the window,
//     max(0, q_lo - W + 1) / BKV, to the diagonal (causal) or the end;
//   - dK/dV: each query head of the kv head's group in turn, and the q tiles
//     from the diagonal to the last whose window still reaches the tile,
//     min(nq - 1, (k_lo + BKV - 1 + W - 1) / BQ); dK and dV sum in fp32 in
//     the CTA and are written once, in kv-head shape, with no atomics and no
//     [b, hq, s, d] gradient to reduce afterwards.
// Nothing carries between q tiles, and a ragged last tile is masked, so any
// sequence length runs.
//
// The bf16 forward (fwd_tile_sm90, both forward kernels) is built for Hopper:
//   - persistent: one CTA an SM takes q tiles of 128 rows in turn from the
//     nq x b*hq tiles ordered heaviest causal tile first, in snake order
//     (odd rounds of the grid run the CTAs backwards), so heavy and light
//     tiles pair up on each SM;
//   - warp-specialised: one producer warpgroup gives its registers to two
//     consumer warpgroups (setmaxnreg) and one of its threads issues TMA
//     loads (cp.async.bulk.tensor over 3-D maps [b*h, s, D], 128-byte
//     swizzle, so a ragged tile reads zeros, never the next head's rows) under
//     mbarriers: Q once a tile, K and V tiles of 128 rows through a two-stage
//     ring that runs ahead across tiles, with K and V released separately;
//   - each consumer warpgroup owns 64 query rows: S = Q K^T by wgmma from
//     shared memory into registers; the mask only on tiles that cut it
//     (diagonal, window edge, ragged end); an online softmax in registers in
//     base 2 (ex2 of log2e-scaled scores; row max and sum over the 4 threads
//     of a quad); P rounded to bf16 in registers is the A operand of
//     O += P V (wgmma, V read MN-major through the transpose bit), and O stays
//     in registers. S of tile j + 1 and P V of tile j are in flight while the
//     softmax of tile j + 1 runs, and the two warpgroups take turns to issue
//     their products (named barriers), so one's softmax runs under the other's;
//   - the epilogue writes O / l in bf16 into a swizzled staging tile that one
//     TMA store writes out (rows >= sq dropped) while the next tile starts.
// The bf16 dK/dV (dkv_tile_sm90, both dK/dV kernels) is built the same way:
//   - a CTA owns a kv tile of 128 rows of one kv head; the grid runs
//     kv-tile-major, so the heaviest causal and band tiles (the low ones)
//     start first; K and V are loaded once by TMA;
//   - one producer warpgroup (setmaxnreg 24): its thread 0 issues TMA loads
//     of Q and dO through a two-stage ring that runs ahead across q tiles
//     and query heads of the group, Q and dO released separately; lse and
//     delta (fp32 rows of sq * 4 bytes, which break TMA's 16-byte stride
//     rule when sq % 4 != 0) are copied into the stage by its threads, one
//     row each, loaded before the stage frees and written after, with lse
//     pre-scaled by -log2e; a stage is full on one TMA arrival and those
//     threads' arrivals;
//   - two consumer warpgroups (setmaxnreg 240) own 64 kv rows each and
//     compute the transposed products, so that no product reads a register
//     tile it cannot hold: S^T = K Q^T and dP^T = V dO^T by wgmma from
//     shared memory (K-major, as the forward's S) into registers; P^T =
//     ex2(S^T log2e - lse log2e), exactly 0 where the mask drops the pair
//     (tested only on tiles that cut it); dS^T = P^T (dP^T - delta); both
//     rounded to bf16 in registers as the register A operands of dV += P^T dO
//     and dK += dS^T Q (wgmma, dO and Q read MN-major through the transpose
//     bit). q tiles of 128 rows at D 64 and 64 at D 128, so dK + dV and S^T +
//     dP^T take 192 fp32 registers a thread at both; dK and dV stay in
//     registers across all q tiles and heads. The two warpgroups take turns
//     to issue (named barriers), so one's exponentials run under the other's
//     products;
//   - the epilogue writes dK and dV in bf16 into the warpgroup's own rows of
//     the K and V tiles (no other product reads them), in the swizzle, and
//     two TMA stores write them out (rows >= skv dropped); a kv tile no query
//     sees loads nothing and writes zeros.
// The bf16 dQ (dq_tile_sm90, both dQ kernels) is the dK/dV turned around:
//   - a CTA owns a q tile of 128 rows of one query row; the grid runs
//     q-tile-major, so the heaviest causal tiles (the last ones) start
//     first; Q and dO are loaded once by TMA;
//   - one producer warpgroup (setmaxnreg 24): its thread 0 issues TMA loads
//     of K and V tiles through a two-stage ring, from the first kv tile
//     inside the window to the last the tile sees, K and V released
//     separately; the band kernel reads kv row (b * hq + h) / groups;
//   - two consumer warpgroups (setmaxnreg 240) own 64 query rows each. A
//     thread's two rows keep their lse (pre-scaled by -log2e) and delta in
//     registers, loaded once. S = Q K^T and dP = dO V^T by wgmma from shared
//     memory (K-major) into registers; P = ex2(S log2e - lse log2e), exactly
//     0 where the mask drops the pair (tested only on tiles that cut it);
//     dS = P (dP - delta), rounded to bf16 in registers as the register A
//     operand of dQ += dS K (wgmma, K read MN-major through the transpose
//     bit). kv tiles of 128 rows (S + dP + dQ: 160 fp32 registers a thread
//     at D 64, 192 at D 128); dQ stays in registers across all kv tiles.
//     The two warpgroups take turns to issue (named barriers), two turns a
//     tile, so one's exponentials run under the other's products;
//   - the epilogue writes dQ in bf16 into the warpgroup's own rows of the Q
//     tile, in the swizzle, and one TMA store writes them out (rows >= sq
//     dropped).
// The fp32 kernels keep the first design: tiles of 64 x 64 (32 x 64 at
// D = 128), every operand tile, the fp32 scores and the fp32 accumulators in
// shared memory, loaded synchronously; products by scalar fp32 FMAs (TF32
// would break the fp32 parity tolerance).
//
// Bounds on an H100 SXM (NVIDIA data sheet: 3.35 TB/s HBM3, 989 TFLOP/s bf16
// dense):
//   - rectangular, GPT-2 small, b 8, h 12, s 1024, d 64, bf16, causal:
//     forward reads q, k, v and writes o (50.3 MB, 15.0 us) for two causal
//     s x s x d products (12.9 GFLOP, 13.0 us): bound by bytes, 15.0 us; dQ
//     (62.9 MB, 18.8 us; three products, 19.3 GFLOP, 19.5 us) and dK/dV
//     (75.5 MB, 22.5 us; four products, 25.8 GFLOP, 26.0 us) are bound by
//     operations;
//   - band, Mistral-7B's width, b 1, hq 32, hkv 8, s 8192, d 128, W 4096,
//     bf16: each head has sum_i min(i + 1, 4096) = 25,167,872 (query, key)
//     pairs, 805.4 M in all, at 2 d flops per pair and product: forward
//     412.4 GFLOP, 0.417 ms (its 168 MB of q, k, v, o and lse need
//     0.050 ms); dQ 618.5 GFLOP, 0.625 ms; dK/dV 824.7 GFLOP, 0.834 ms; all
//     bound by operations.
// Every design here keeps the s x s scores out of device memory (each K/V or
// Q/dO tile is read once per CTA that needs it, from L2 after the first) and
// works only on tiles inside the mask, so band time scales with W and not
// s^2. What still holds the bf16 forward from its bound: at d 64 the 64 ex2
// a thread takes per kv tile cost the SM's 16-a-clock special-function unit
// as long as the tile's products take the tensor cores, and the two only
// partly overlap; each K/V tile is read from L2 once per 128-row q tile that
// needs it; the last tiles of a causal grid leave SMs idle. The bf16 dK/dV
// at d 128 runs S^T and dP^T as m64n64 products with both operands in shared
// memory: by count, 4 KB of operands a k16 step at the tensor cores' rate
// is 128 bytes a clock, about all of the SM's shared-memory rate (not
// measured); at d 64 each CTA has few q tiles, and its K/V load and
// epilogue are not hidden. The bf16 dQ has the dK/dV's limits turned
// around: at d 64 its exponentials (one per pair, as the forward's) load the
// special-function unit as much as its three products load the tensor
// cores; S and dP read both operands from shared memory; each CTA is one q
// tile, so its Q/dO load and epilogue are not hidden, and a causal grid's
// light first tiles run last. The fp32 kernels do not reach
// theirs: synchronous loads and scalar FMAs.
//
// Numerics kept from the TPU kernels:
//   - masked logits are NEG_INF = -1e30 (not -inf);
//   - forward: online softmax with fp32 m, l and accumulator; p is rounded to
//     the input dtype before P.V; l sums the unrounded p; a row with l == 0
//     writes 0 and lse = m + log(1). A masked entry's p is
//     exp(-1e30 - m) = 0 wherever its row has seen a key, which every row
//     has by its first tile unless a window cuts that tile's keys: then the
//     TPU kernel sets the row's p to 1 and wipes it with the next tile's
//     correction exp(-1e30 - m_new) = 0. Under a window the forward writes
//     p = 0 for a masked entry instead: the same result without the
//     transient. The bf16 forward takes p = 2^(s log2e - m log2e) with the
//     hardware's ex2 (about 2 ulp), which moves lse by a few fp32 ulps;
//   - backward: p = exp(s - lse) recomputed; dS = p * (dP - delta) in fp32,
//     rounded to the input dtype before dS.K and dS^T.Q; p rounded before
//     P^T.dO. delta = rowsum(dO * O) comes in from the wrapper. The bf16
//     dQ and dK/dV take p = 2^(s log2e - lse log2e) with the hardware's
//     ex2, which moves dQ, dK and dV by a few bf16 ulps at most, and write
//     p = 0 for a masked pair (the TPU kernel's exp(-1e30 - lse) is 0 too).
//     No atomics: two launches give equal bits.
//
// Each C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a dtype, head_dim or shape it does not take; the
// Python wrapper (accelerate_tpu_torch/ops/flash_attention.py) raises if the
// code is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sm90.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Tile shape for element type T and head dim D: BQ query rows, BKV kv rows.
template <typename T, int D>
struct Tiles {
  static constexpr int BQ = (sizeof(T) == 4 && D == 128) ? 32 : 64;
  static constexpr int BKV = 64;
  static constexpr int LDT = D + 8;     // operand tiles [rows][D] in T
  static constexpr int LDS = BKV + 4;   // fp32 score tiles [BQ][BKV]
  static constexpr int LDP = BKV + 8;   // rounded probability tiles [BQ][BKV] in T
  static constexpr int LDA = D + 4;     // fp32 accumulators [rows][D]
};

// Which (query i, key j) pairs attend, and the tiles that hold them. BAND
// false: the rectangular kernels (all pairs, or j <= i when CAUSAL; groups 1,
// no window). BAND true: the band kernels (always CAUSAL; j > i - window when
// window > 0; K/V row = (b * hq + h) / groups).
template <bool CAUSAL, bool BAND>
struct Mask {
  int sq, skv;
  int groups_;  // read through groups(): 1 unless BAND
  int window_;  // read through windowed(): 0 (none) unless BAND

  __host__ __device__ __forceinline__ int groups() const { return BAND ? groups_ : 1; }
  __device__ __forceinline__ bool windowed() const { return BAND && window_ > 0; }
  __device__ __forceinline__ bool keep(int qi, int kj) const {
    return kj < skv && (!CAUSAL || kj <= qi) && (!windowed() || kj > qi - window_);
  }
  // every pair of queries [q_first, q_last] x keys [k_first, k_last] attends
  __device__ __forceinline__ bool keeps_all(int q_first, int q_last, int k_first, int k_last) const {
    return k_last < skv && (!CAUSAL || k_last <= q_first) && (!windowed() || k_first > q_last - window_);
  }
  // kv tiles [kv_begin, kv_end) hold every key the query rows [q_lo, q_lo + bq) see
  __device__ __forceinline__ int kv_begin(int q_lo, int bkv) const {
    return windowed() ? max(0, q_lo - window_ + 1) / bkv : 0;
  }
  __device__ __forceinline__ int kv_end(int q_lo, int bq, int bkv) const {
    const int n = (skv + bkv - 1) / bkv;
    return CAUSAL ? min(n, (q_lo + bq - 1) / bkv + 1) : n;
  }
  // q tiles [q_begin, q_end) hold every query that sees a key of
  // [k_lo, k_lo + bkv): from the diagonal to the last row whose window
  // still reaches the tile's last key, k_lo + bkv - 1 + window - 1
  __device__ __forceinline__ int q_begin(int k_lo, int bq) const { return CAUSAL ? k_lo / bq : 0; }
  __device__ __forceinline__ int q_end(int k_lo, int bq, int bkv) const {
    const int n = (sq + bq - 1) / bq;
    return windowed() ? min(n, (k_lo + bkv + window_ - 2) / bq + 1) : n;
  }
};

using BandMask = Mask<true, true>;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// rows [row0, row0 + ROWS) of a contiguous [n_rows, D] matrix into shared
// memory (leading dim LD), 16 bytes per thread per step; rows >= n_rows are 0
template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// fp32 rows of a [n_rows] vector into shared memory; rows >= n_rows are 0
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n_rows,
                                          int rows) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    dst[i] = row0 + i < n_rows ? src[row0 + i] : 0.f;
  }
}

// C[M][N] (=, or += when ACC) op(A)[M][K] . op(B)[K][N], all in shared memory.
// A_T: A is stored [K][M] (use its transpose), else [M][K]. B_T: B is stored
// [N][K], else [K][N]. fp32 inputs: scalar FMAs, each thread owns a
// (M/16) x (N/16) block of C (columns strided by 16).
template <int M, int N, int K, bool A_T, bool B_T, bool ACC>
__device__ __forceinline__ void gemm(float* C, int ldc, const float* A, int lda, const float* B,
                                     int ldb) {
  constexpr int TM = M / 16;
  constexpr int TN = N / 16;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = ACC ? C[(ty * TM + i) * ldc + tx + j * 16] : 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty * TM + i;
      a[i] = A_T ? A[k * lda + m] : A[m * lda + k];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + j * 16;
      b[j] = B_T ? B[n * ldb + k] : B[k * ldb + n];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) C[(ty * TM + i) * ldc + tx + j * 16] = acc[i][j];
  }
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  using C = Tiles<T, D>;
  return sizeof(T) * (C::BQ * C::LDT + 2 * C::BKV * C::LDT + C::BQ * C::LDP) +
         sizeof(float) * (C::BQ * C::LDS + C::BQ * C::LDA + 3 * C::BQ);
}

// Forward for the q tile nq - 1 - blockIdx.x (the heaviest causal tiles start
// first) of row blockIdx.y = b * hq + h: o and lse.
template <typename T, int D, typename M>
__device__ __forceinline__ void fwd_tile(unsigned char* smem, const T* __restrict__ q,
                                         const T* __restrict__ k, const T* __restrict__ v,
                                         T* __restrict__ o, float* __restrict__ lse,
                                         const M mask) {
  using C = Tiles<T, D>;
  constexpr int BQ = C::BQ, BKV = C::BKV;
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + BQ * C::LDT;
  T* v_s = k_s + BKV * C::LDT;
  T* p_s = v_s + BKV * C::LDT;
  float* s_s = reinterpret_cast<float*>(p_s + BQ * C::LDP);
  float* acc = s_s + BQ * C::LDS;
  float* m_s = acc + BQ * C::LDA;
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;

  const int sq = mask.sq, skv = mask.skv;
  const int nq = (sq + BQ - 1) / BQ;
  const int iq = nq - 1 - blockIdx.x;
  const int q_lo = iq * BQ;
  const size_t bh = blockIdx.y;
  const size_t bkv = bh / mask.groups();
  const T* qb = q + bh * sq * D;
  const T* kb = k + bkv * skv * D;
  const T* vb = v + bkv * skv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<T, BQ, D, C::LDT>(q_s, qb, q_lo, sq);
  for (int i = threadIdx.x; i < BQ * C::LDA; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  const int ik_end = mask.kv_end(q_lo, BQ, BKV);

  for (int ik = mask.kv_begin(q_lo, BKV); ik < ik_end; ++ik) {
    __syncthreads();  // the last tile's readers of k_s, v_s and p_s are done
    load_tile<T, BKV, D, C::LDT>(k_s, kb, ik * BKV, skv);
    load_tile<T, BKV, D, C::LDT>(v_s, vb, ik * BKV, skv);
    __syncthreads();
    gemm<BQ, BKV, D, false, true, false>(s_s, C::LDS, q_s, C::LDT, k_s, C::LDT);
    __syncthreads();
    // online softmax, one warp per row, two columns per lane
    for (int r = warp; r < BQ; r += kWarps) {
      const int qi = q_lo + r;
      float s[BKV / 32];
      bool keep[BKV / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j;
        keep[j] = mask.keep(qi, ik * BKV + c);
        s[j] = keep[j] ? s_s[r * C::LDS + c] : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const float p = mask.windowed() && !keep[j] ? 0.f : expf(s[j] - m_new);
        sum += p;
        p_s[r * C::LDP + lane + 32 * j] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      acc[r * C::LDA + c] *= corr_s[r];
    }
    __syncthreads();
    gemm<BQ, D, BKV, false, false, true>(acc, C::LDA, p_s, C::LDP, v_s, C::LDT);
  }
  __syncthreads();
  T* ob = o + bh * sq * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q_lo + r;
    if (qi < sq) {
      const float l = l_s[r];
      ob[(size_t)qi * D + c] = acc[r * C::LDA + c] / (l == 0.f ? 1.f : l);
    }
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int qi = q_lo + r;
    if (qi < sq) {
      const float l = l_s[r];
      lse[bh * sq + qi] = m_s[r] + logf(l == 0.f ? 1.f : l);
    }
  }
}

// ------------------------------------------------- the bf16 forward on sm_90a
// The bf16 forward's tiles: a CTA is two consumer warpgroups of 64 query rows
// each and one producer warpgroup whose first thread issues the TMA loads.
constexpr int kSm90Threads = 3 * 128;

template <int D>
struct Sm90Fwd {
  static constexpr int BQ = 128;
  static constexpr int BKV = 128;
  static constexpr int STAGES = 2;  // the K/V ring
  static constexpr int kQBytes = BQ * D * 2;
  static constexpr int kKVBytes = BKV * D * 2;  // one K or V tile
  // Q, the O staging tile, the ring, 1024 bytes of slack to align the tiles
  // to the swizzle's 8 x 128-byte period, and the mbarriers: full and empty
  // for Q, and per stage full and empty for K and for V
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 2 * STAGES * kKVBytes + 8 * (2 + 4 * STAGES);
};

static_assert(Sm90Fwd<128>::kSmem <= kMaxSmem, "bf16 forward tile exceeds shared memory");

// The bf16 forward's TMA maps, q and o over [b * hq, sq, D], k and v over
// [b * hkv, skv, D], in boxes of 64 columns (one 128-byte swizzle atom), and
// its count of q rows b * hq (the grid is one CTA an SM)
struct FwdMaps {
  CUtensorMap q, k, v, o;
  int bh;
};

// The bf16 forward, persistent: CTA blockIdx.x takes one q tile in each
// round of the grid over the nq x bh tiles, heaviest causal tiles first
// (tile t is q tile nq - 1 - t / bh of row t % bh = b * hq + h), and writes o
// (through maps.o) and lse. Shared memory holds Q, an O staging tile and a
// ring of STAGES K and V tiles, all in the 128-byte swizzle, as [D / 64
// column blocks][rows][64]; the producer runs ahead across tiles, so the next
// tile's Q and K/V loads and the last tile's O store overlap the products.
// S, P and O stay in registers.
template <int D, typename M>
__device__ __forceinline__ void fwd_tile_sm90(unsigned char* smem_raw, const FwdMaps& maps,
                                              float* __restrict__ lse, const M mask) {
  using C = Sm90Fwd<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, S = C::STAGES;
  constexpr float kLog2e = 1.4426950408889634f;
  unsigned char* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* o_s = q_s + C::kQBytes;
  unsigned char* k_s = o_s + C::kQBytes;       // stage st at + st * kKVBytes
  unsigned char* v_s = k_s + S * C::kKVBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(v_s + S * C::kKVBytes);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = empty_q + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;

  const int sq = mask.sq, skv = mask.skv;
  const int nq = (sq + BQ - 1) / BQ;
  const int bh_rows = maps.bh;
  const int n_work = nq * bh_rows;
  // this CTA's k-th tile: round k of the grid, in snake order (odd rounds
  // run the CTAs backwards), so heavy and light causal tiles pair up
  auto work_tile = [&](int k) {
    return k * static_cast<int>(gridDim.x) +
           (k % 2 ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : static_cast<int>(blockIdx.x));
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 2 * 128);  // every consumer thread releases a buffer
    for (int st = 0; st < S; ++st) {
      mbar_init(full_k + st, 1);
      mbar_init(full_v + st, 1);
      mbar_init(empty_k + st, 2 * 128);
      mbar_init(empty_v + st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: hands its registers to the consumers; one thread loads each
    // tile's Q once the last tile's products are done with it, and keeps up
    // to S K/V tiles ahead of the consumers, across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      int fill = 0, n_done = 0;
      for (int t; (t = work_tile(n_done)) < n_work; ++n_done) {
        const int q_lo = (nq - 1 - t / bh_rows) * BQ;
        const int bh = t % bh_rows;
        const int bkv = bh / mask.groups();
        const int ik_begin = mask.kv_begin(q_lo, BKV);
        const int n_tiles = mask.kv_end(q_lo, BQ, BKV) - ik_begin;
        if (n_done > 0) mbar_wait(empty_q, (n_done - 1) & 1);
        mbar_expect_tx(full_q, C::kQBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) tma_load(q_s + c * BQ * 128, &maps.q, full_q, 64 * c, q_lo, bh);
        for (int it = 0; it < n_tiles; ++it, ++fill) {
          const int st = fill % S;
          const int kv_row = (ik_begin + it) * BKV;
          if (fill >= S) mbar_wait(empty_k + st, (fill / S - 1) & 1);  // the consumers released it
          mbar_expect_tx(full_k + st, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load(k_s + st * C::kKVBytes + c * BKV * 128, &maps.k, full_k + st, 64 * c, kv_row, bkv);
          }
          if (fill >= S) mbar_wait(empty_v + st, (fill / S - 1) & 1);
          mbar_expect_tx(full_v + st, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load(v_s + st * C::kKVBytes + c * BKV * 128, &maps.v, full_v + st, 64 * c, kv_row, bkv);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q_lo + 64 wg + [0, 64) of each
    // tile; this thread holds rows row0 and row0 + 8 of S and O, columns
    // 8 j + col0 + {0, 1} (the wgmma accumulator layout)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_addr(q_s) + 64 * wg * 128;
    float o[D / 2], s[BKV / 2];
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    // ping-pong: the two warpgroups take turns to issue their products
    // (named barriers 3 and 4), so one's softmax runs under the other's;
    // warpgroup 0 goes first
    auto turn_begin = [&]() { asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory"); };
    auto turn_end = [&]() { asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory"); };
    if (wg == 1) turn_end();
    int fill = 0, n_done = 0;
    for (int t; (t = work_tile(n_done)) < n_work; ++n_done) {
      const int q_lo = (nq - 1 - t / bh_rows) * BQ;
      const int bh = t % bh_rows;
      const int ik_begin = mask.kv_begin(q_lo, BKV);
      const int n_tiles = mask.kv_end(q_lo, BQ, BKV) - ik_begin;
      const int wg_first = q_lo + 64 * wg, wg_last = wg_first + 63;
      const int row0 = wg_first + 16 * warp + lane / 4;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's partial row sums
      float corr[2] = {1.f, 1.f};

      // S = Q K_it^T, issued: both K-major; a k16 step is 32 bytes into a
      // 64-column block
      auto issue_s = [&](int it) {
        const int st = (fill + it) % S;
        const uint32_t k_addr = smem_addr(k_s) + st * C::kKVBytes;
        mbar_wait(full_k + st, ((fill + it) / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          Wgmma<BKV>::ss(s, sw128_desc(q_addr + (kk / 4) * BQ * 128 + off, 16, 1024),
                         sw128_desc(k_addr + (kk / 4) * BKV * 128 + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
      };
      // O += P_it V_it, issued: V is MN-major (transpose bit); a k16 step is
      // 16 rows of 128 bytes; LBO steps to the next 64-column block of D
      auto issue_pv = [&](int it) {
        const int st = (fill + it) % S;
        const uint32_t v_addr = smem_addr(v_s) + st * C::kKVBytes;
        mbar_wait(full_v + st, ((fill + it) / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          Wgmma<D>::rs(o, p[kk], sw128_desc(v_addr + kk * 16 * 128, BKV * 128, 1024));
        }
        wgmma_commit();
      };
      // the online softmax of tile it's finished S, in place: s becomes the
      // unrounded p; m, l and corr move
      auto softmax = [&](int it) {
        const int k_lo = (ik_begin + it) * BKV;
        const bool cut = !mask.keeps_all(wg_first, wg_last, k_lo, k_lo + BKV - 1);
        uint64_t dropped = 0;
        if (cut) {  // only tiles that cut the mask: diagonal, window edge, ragged end
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            if (!mask.keep(row0 + 8 * ((i / 2) % 2), k_lo + 8 * (i / 4) + col0 + i % 2)) {
              s[i] = kNegInf;
              dropped |= 1ull << i;
            }
          }
        }
        if (!mask.windowed()) dropped = 0;  // elsewhere exp(-1e30 - m) is 0 already
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
        float neg[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          corr[r] = fast_exp2((m[r] - m_new) * kLog2e);
          m[r] = m_new;
          neg[r] = -m_new * kLog2e;
          l[r] *= corr[r];
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int r = (i / 2) % 2;
          float e = fast_exp2(fmaf(s[i], kLog2e, neg[r]));
          if (dropped >> i & 1) e = 0.f;  // under a window a masked p is exactly 0
          l[r] += e;  // l sums the unrounded p
          s[i] = e;
        }
      };
      // p rounded to bf16, the register A operand of P.V: the accumulator
      // layout of S matches the A fragment layout of m64k16
      auto round_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };

      mbar_wait(full_q, n_done & 1);
      turn_begin();
      issue_s(0);
      turn_end();
      wgmma_wait<0>();
      mbar_arrive(empty_k + fill % S);
      softmax(0);
      round_p();
      // S of tile it and P V of tile it - 1 run on the tensor cores while
      // the softmax of tile it runs
      for (int it = 1; it < n_tiles; ++it) {
        turn_begin();
        issue_s(it);
        issue_pv(it - 1);
        turn_end();
        wgmma_wait<1>();  // S of tile it (groups complete in order)
        mbar_arrive(empty_k + (fill + it) % S);
        softmax(it);
        wgmma_wait<0>();
        mbar_arrive(empty_v + (fill + it - 1) % S);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];  // into tile it's max
        round_p();
      }
      mbar_arrive(empty_q);  // the last S product has read Q
      turn_begin();
      issue_pv(n_tiles - 1);
      turn_end();
      wgmma_wait<0>();
      mbar_arrive(empty_v + (fill + n_tiles - 1) % S);
      fill += n_tiles;

      // epilogue: l over the quad; O / l in bf16 into this warpgroup's rows
      // of the O tile, in the swizzle, once the last tile's store has read
      // them; then one TMA store that drops rows >= sq; lse = m + log(l),
      // l == 0 -> 1
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
        l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
        if (l[r] == 0.f) l[r] = 1.f;
        inv[r] = 1.f / l[r];
      }
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int r = (i / 2) % 2;
        const int row = 64 * wg + 16 * warp + lane / 4 + 8 * r;  // in the tile
        const int col = 8 * (i / 4) + col0;
        const int cc = col % 64;
        const int byte = (col / 64) * BQ * 128 + row * 128 + (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
        *reinterpret_cast<uint32_t*>(o_s + byte) = pack_bf16(o[i] * inv[r], o[i + 1] * inv[r]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      if (tid == 0 && wg_first < sq) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_store(&maps.o, o_s + c * BQ * 128 + 64 * wg * 128, 64 * c, wg_first, bh);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = row0 + 8 * r;
          if (qi < sq) lse[static_cast<size_t>(bh) * sq + qi] = m[r] + logf(l[r]);
        }
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

template <typename T, int D>
constexpr size_t dq_smem() {
  using C = Tiles<T, D>;
  return sizeof(T) * (2 * C::BQ * C::LDT + 2 * C::BKV * C::LDT + C::BQ * C::LDP) +
         sizeof(float) * (2 * C::BQ * C::LDS + C::BQ * C::LDA + 2 * C::BQ);
}

// dQ for the q tile nq - 1 - blockIdx.x of row blockIdx.y = b * hq + h.
template <typename T, int D, typename M>
__device__ __forceinline__ void dq_tile(unsigned char* smem, const T* __restrict__ q,
                                        const T* __restrict__ k, const T* __restrict__ v,
                                        const T* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, T* __restrict__ dq,
                                        const M mask) {
  using C = Tiles<T, D>;
  constexpr int BQ = C::BQ, BKV = C::BKV;
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + BQ * C::LDT;
  T* k_s = do_s + BQ * C::LDT;
  T* v_s = k_s + BKV * C::LDT;
  T* ds_s = v_s + BKV * C::LDT;
  float* s_s = reinterpret_cast<float*>(ds_s + BQ * C::LDP);
  float* dp_s = s_s + BQ * C::LDS;
  float* acc = dp_s + BQ * C::LDS;
  float* lse_s = acc + BQ * C::LDA;
  float* delta_s = lse_s + BQ;

  const int sq = mask.sq, skv = mask.skv;
  const int nq = (sq + BQ - 1) / BQ;
  const int iq = nq - 1 - blockIdx.x;
  const int q_lo = iq * BQ;
  const size_t bh = blockIdx.y;
  const size_t bkv = bh / mask.groups();
  const T* kb = k + bkv * skv * D;
  const T* vb = v + bkv * skv * D;

  load_tile<T, BQ, D, C::LDT>(q_s, q + bh * sq * D, q_lo, sq);
  load_tile<T, BQ, D, C::LDT>(do_s, dout + bh * sq * D, q_lo, sq);
  load_rows(lse_s, lse + bh * sq, q_lo, sq, BQ);
  load_rows(delta_s, delta + bh * sq, q_lo, sq, BQ);
  for (int i = threadIdx.x; i < BQ * C::LDA; i += kThreads) acc[i] = 0.f;
  const int ik_end = mask.kv_end(q_lo, BQ, BKV);

  for (int ik = mask.kv_begin(q_lo, BKV); ik < ik_end; ++ik) {
    __syncthreads();
    load_tile<T, BKV, D, C::LDT>(k_s, kb, ik * BKV, skv);
    load_tile<T, BKV, D, C::LDT>(v_s, vb, ik * BKV, skv);
    __syncthreads();
    gemm<BQ, BKV, D, false, true, false>(s_s, C::LDS, q_s, C::LDT, k_s, C::LDT);
    gemm<BQ, BKV, D, false, true, false>(dp_s, C::LDS, do_s, C::LDT, v_s, C::LDT);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BKV; i += kThreads) {
      const int r = i / BKV, c = i % BKV;
      const int qi = q_lo + r;
      const bool keep = qi < sq && mask.keep(qi, ik * BKV + c);
      const float p = expf((keep ? s_s[r * C::LDS + c] : kNegInf) - lse_s[r]);
      ds_s[r * C::LDP + c] = p * (dp_s[r * C::LDS + c] - delta_s[r]);
    }
    __syncthreads();
    gemm<BQ, D, BKV, false, false, true>(acc, C::LDA, ds_s, C::LDP, k_s, C::LDT);
  }
  __syncthreads();
  T* dqb = dq + bh * sq * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q_lo + r;
    if (qi < sq) dqb[(size_t)qi * D + c] = acc[r * C::LDA + c];
  }
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  using C = Tiles<T, D>;
  return sizeof(T) * (2 * C::BKV * C::LDT + 2 * C::BQ * C::LDT + C::BQ * C::LDP) +
         sizeof(float) * (2 * C::BQ * C::LDS + 2 * C::BKV * C::LDA + 2 * C::BQ);
}

// dK and dV for the kv tile blockIdx.x of kv row blockIdx.y = b * hkv + h:
// the CTA walks every (query head of the group, q tile) pair whose mask
// covers the tile, sums in fp32 in shared memory, and writes once.
template <typename T, int D, typename M>
__device__ __forceinline__ void dkv_tile(unsigned char* smem, const T* __restrict__ q,
                                         const T* __restrict__ k, const T* __restrict__ v,
                                         const T* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dk,
                                         T* __restrict__ dv, const M mask) {
  using C = Tiles<T, D>;
  constexpr int BQ = C::BQ, BKV = C::BKV;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BKV * C::LDT;
  T* q_s = v_s + BKV * C::LDT;
  T* do_s = q_s + BQ * C::LDT;
  T* pr_s = do_s + BQ * C::LDT;  // rounded p, then rounded dS
  float* p_s = reinterpret_cast<float*>(pr_s + BQ * C::LDP);
  float* dp_s = p_s + BQ * C::LDS;
  float* dk_acc = dp_s + BQ * C::LDS;
  float* dv_acc = dk_acc + BKV * C::LDA;
  float* lse_s = dv_acc + BKV * C::LDA;
  float* delta_s = lse_s + BQ;

  const int sq = mask.sq, skv = mask.skv;
  const int ik = blockIdx.x;  // low kv tiles see the most q tiles when causal: first
  const int k_lo = ik * BKV;
  const size_t bkv = blockIdx.y;

  load_tile<T, BKV, D, C::LDT>(k_s, k + bkv * skv * D, k_lo, skv);
  load_tile<T, BKV, D, C::LDT>(v_s, v + bkv * skv * D, k_lo, skv);
  for (int i = threadIdx.x; i < BKV * C::LDA; i += kThreads) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const int iq_begin = mask.q_begin(k_lo, BQ);
  const int iq_end = mask.q_end(k_lo, BQ, BKV);

  for (int g = 0; g < mask.groups(); ++g) {
    const size_t bh = bkv * mask.groups() + g;
    const T* qb = q + bh * sq * D;
    const T* dob = dout + bh * sq * D;
    for (int iq = iq_begin; iq < iq_end; ++iq) {
      __syncthreads();
      load_tile<T, BQ, D, C::LDT>(q_s, qb, iq * BQ, sq);
      load_tile<T, BQ, D, C::LDT>(do_s, dob, iq * BQ, sq);
      load_rows(lse_s, lse + bh * sq, iq * BQ, sq, BQ);
      load_rows(delta_s, delta + bh * sq, iq * BQ, sq, BQ);
      __syncthreads();
      gemm<BQ, BKV, D, false, true, false>(p_s, C::LDS, q_s, C::LDT, k_s, C::LDT);
      gemm<BQ, BKV, D, false, true, false>(dp_s, C::LDS, do_s, C::LDT, v_s, C::LDT);
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * BKV; i += kThreads) {
        const int r = i / BKV, c = i % BKV;
        const int qi = iq * BQ + r;
        const bool keep = qi < sq && mask.keep(qi, k_lo + c);
        const float p = expf((keep ? p_s[r * C::LDS + c] : kNegInf) - lse_s[r]);
        p_s[r * C::LDS + c] = p;
        pr_s[r * C::LDP + c] = p;
      }
      __syncthreads();
      gemm<BKV, D, BQ, true, false, true>(dv_acc, C::LDA, pr_s, C::LDP, do_s, C::LDT);
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * BKV; i += kThreads) {
        const int r = i / BKV, c = i % BKV;
        pr_s[r * C::LDP + c] =
            p_s[r * C::LDS + c] * (dp_s[r * C::LDS + c] - delta_s[r]);
      }
      __syncthreads();
      gemm<BKV, D, BQ, true, false, true>(dk_acc, C::LDA, pr_s, C::LDP, q_s, C::LDT);
    }
  }
  __syncthreads();
  T* dkb = dk + bkv * skv * D;
  T* dvb = dv + bkv * skv * D;
  for (int i = threadIdx.x; i < BKV * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int kj = k_lo + r;
    if (kj < skv) {
      dkb[(size_t)kj * D + c] = dk_acc[r * C::LDA + c];
      dvb[(size_t)kj * D + c] = dv_acc[r * C::LDA + c];
    }
  }
}

// The bf16 dK/dV tiles: a CTA owns BKV kv rows of one kv head, 64 for each
// of two consumer warpgroups (the wgmma M), and walks q tiles of BQ rows fed
// by one producer warpgroup. A consumer thread holds dK and dV (D fp32) and
// S^T and dP^T (BQ fp32): 192 registers at both head dims.
template <int D>
struct Sm90Dkv {
  static constexpr int BKV = 128;
  static constexpr int BQ = D == 64 ? 128 : 64;
  static constexpr int STAGES = 2;              // the Q/dO ring
  static constexpr int kKVBytes = BKV * D * 2;  // one K or V tile
  static constexpr int kQBytes = BQ * D * 2;    // one Q or dO tile
  // K, V, the ring's Q and dO tiles and its rows of -lse log2e and delta,
  // 1024 bytes of slack to align the tiles to the swizzle's 8 x 128-byte
  // period, and the mbarriers: full for K/V, and per stage full and empty
  // for Q and for dO
  static constexpr size_t kSmem =
      1024 + 2 * kKVBytes + STAGES * (2 * kQBytes + 2 * BQ * 4) + 8 * (1 + 4 * STAGES);
};

// The bf16 dK/dV's TMA maps: q and dO over [b * hq, sq, D] in boxes of BQ
// rows, k and v over [b * hkv, skv, D] in boxes of BKV rows, dk and dv over
// the same in boxes of 64 rows (a warpgroup's), all of 64 columns
struct DkvMaps {
  CUtensorMap q, dout, k, v, dk, dv;
};

// dK and dV for the kv tile blockIdx.y of kv row blockIdx.x = b * hkv + h
// (the grid runs kv-tile-major, so the heaviest causal and band tiles, the
// low ones, start first). Shared memory holds this tile's K and V, loaded
// once, and a ring of STAGES Q and dO tiles, all in the 128-byte swizzle as
// [D / 64 column blocks][rows][64], with each stage's -lse log2e and delta
// rows; the producer runs the ring ahead across q tiles and query heads.
// Each consumer warpgroup computes, for its 64 kv rows, the transposed
// products S^T = K Q^T and dP^T = V dO^T into registers, P^T and dS^T there,
// and dV += P^T dO and dK += dS^T Q with the rounded P^T and dS^T as register
// A operands; dK and dV stay in registers across all q tiles and leave once.
template <int D, typename M>
__device__ __forceinline__ void dkv_tile_sm90(unsigned char* smem_raw, const DkvMaps& maps,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta, const M mask) {
  using C = Sm90Dkv<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, S = C::STAGES;
  constexpr float kLog2e = 1.4426950408889634f;
  unsigned char* k_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* v_s = k_s + C::kKVBytes;
  unsigned char* q_s = v_s + C::kKVBytes;  // stage st at + st * kQBytes
  unsigned char* do_s = q_s + S * C::kQBytes;
  float* nlse_s = reinterpret_cast<float*>(do_s + S * C::kQBytes);  // [S][BQ]: -lse log2e
  float* delta_s = nlse_s + S * BQ;                                  // [S][BQ]
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(delta_s + S * BQ);
  uint64_t* full_q = full_kv + 1;
  uint64_t* full_do = full_q + S;
  uint64_t* empty_q = full_do + S;
  uint64_t* empty_do = empty_q + S;

  const int sq = mask.sq, skv = mask.skv;
  const int kv_row = blockIdx.x;
  const int k_lo = blockIdx.y * BKV;
  const int groups = mask.groups();
  const int iq_begin = mask.q_begin(k_lo, BQ);
  const int n_iq = max(0, mask.q_end(k_lo, BQ, BKV) - iq_begin);
  // q tiles this CTA walks: n_iq for each query head of the group, in turn.
  // With none (keys no query sees) nothing is loaded and dK, dV are 0
  const int n = groups * n_iq;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full_q + st, 1);
      mbar_init(full_do + st, BQ);  // thread 0's TMA arrival and the other rows' writers
      mbar_init(empty_q + st, 2 * 128);  // every consumer thread releases a buffer
      mbar_init(empty_do + st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: hands its registers to the consumers. Its thread p < BQ
    // keeps row q_lo + p of each stage's lse and delta (their fp32 rows of
    // sq * 4 bytes break TMA's 16-byte stride rule when sq % 4 != 0): it
    // loads the values before it waits for the stage, writes them once the
    // consumers have released it, and arrives on the stage's dO barrier.
    // Thread 0 also loads K and V once and issues the stage's TMA loads, up
    // to S q tiles ahead of the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int p = threadIdx.x - 2 * 128;
    if (p == 0 && n > 0) {
      mbar_expect_tx(full_kv, 2 * C::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(k_s + c * BKV * 128, &maps.k, full_kv, 64 * c, k_lo, kv_row);
        tma_load(v_s + c * BKV * 128, &maps.v, full_kv, 64 * c, k_lo, kv_row);
      }
    }
    for (int t = 0; t < n && p < BQ; ++t) {
      const int st = t % S;
      const int bh = kv_row * groups + t / n_iq;
      const int q_lo = (iq_begin + t % n_iq) * BQ;
      const int qi = q_lo + p;
      const size_t at = static_cast<size_t>(bh) * sq + qi;
      const float nl = qi < sq ? -lse[at] * kLog2e : 0.f;
      const float dl = qi < sq ? delta[at] : 0.f;
      if (t >= S) mbar_wait(empty_do + st, (t / S - 1) & 1);  // the consumers released it
      nlse_s[st * BQ + p] = nl;
      delta_s[st * BQ + p] = dl;
      if (p == 0) {
        mbar_expect_tx(full_do + st, C::kQBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(do_s + st * C::kQBytes + c * BQ * 128, &maps.dout, full_do + st, 64 * c, q_lo, bh);
        }
        if (t >= S) mbar_wait(empty_q + st, (t / S - 1) & 1);
        mbar_expect_tx(full_q + st, C::kQBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(q_s + st * C::kQBytes + c * BQ * 128, &maps.q, full_q + st, 64 * c, q_lo, bh);
        }
      } else {
        mbar_arrive(full_do + st);
      }
    }
  } else {
    // consumers: warpgroup wg owns kv rows k_lo + 64 wg + [0, 64); this
    // thread holds rows row0 and row0 + 8 of S^T, dP^T, dK and dV, columns
    // 8 j + col0 + {0, 1} (the wgmma accumulator layout): q rows of S^T and
    // dP^T, d of dK and dV
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const int wg_first = k_lo + 64 * wg, wg_last = wg_first + 63;
    const int row0 = wg_first + 16 * warp + lane / 4;
    const uint32_t k_addr = smem_addr(k_s) + 64 * wg * 128;  // this warpgroup's rows
    const uint32_t v_addr = smem_addr(v_s) + 64 * wg * 128;
    float dk[D / 2], dv[D / 2], s[BQ / 2], dp[BQ / 2];
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    // ping-pong: the two warpgroups take turns to issue their products
    // (named barriers 3 and 4), so one's exponentials and dS run under the
    // other's products; warpgroup 0 goes first
    auto turn_begin = [&]() { asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory"); };
    auto turn_end = [&]() { asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory"); };
    if (wg == 1) turn_end();
    if (n > 0) mbar_wait(full_kv, 0);

    for (int t = 0; t < n; ++t) {
      const int st = t % S;
      const uint32_t parity = (t / S) & 1;
      const uint32_t q_addr = smem_addr(q_s) + st * C::kQBytes;
      const uint32_t do_addr = smem_addr(do_s) + st * C::kQBytes;
      const int q_lo = (iq_begin + t % n_iq) * BQ;
      mbar_wait(full_q + st, parity);
      mbar_wait(full_do + st, parity);
      // S^T = K Q^T and dP^T = V dO^T: all K-major; a k16 step is 32 bytes
      // into a 64-column block
      turn_begin();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BKV * 128 + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        Wgmma<BQ>::ss(s, sw128_desc(k_addr + off, 16, 1024), sw128_desc(q_addr + b_off, 16, 1024),
                      kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BKV * 128 + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        Wgmma<BQ>::ss(dp, sw128_desc(v_addr + off, 16, 1024), sw128_desc(do_addr + b_off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();

      // P^T = 2^(S^T log2e - lse log2e), exactly 0 where the mask drops the
      // pair (tested only on tiles that cut it: diagonal, window edge, ragged
      // ends); dS^T = P^T (dP^T - delta), from the unrounded p
      const float* nl = nlse_s + st * BQ;
      const float* dl = delta_s + st * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(nl + 8 * j + col0);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], kLog2e, e % 2 ? l2.y : l2.x));
      }
      if (q_lo + BQ > sq || !mask.keeps_all(q_lo, q_lo + BQ - 1, wg_first, wg_last)) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int qi = q_lo + 8 * (i / 4) + col0 + i % 2;
          if (!(qi < sq && mask.keep(qi, row0 + 8 * ((i / 2) % 2)))) s[i] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + col0);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e % 2 ? d2.y : d2.x));
      }
      // P^T and dS^T rounded to bf16, the register A operands: the
      // accumulator layout matches the A fragment layout of m64k16
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          dsa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q are MN-major (transpose
      // bit); a k16 step is 16 rows of 128 bytes; LBO steps to the next
      // 64-column block of D
      turn_begin();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        Wgmma<D>::rs(dv, pa[kk], sw128_desc(do_addr + kk * 16 * 128, BQ * 128, 1024));
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        Wgmma<D>::rs(dk, dsa[kk], sw128_desc(q_addr + kk * 16 * 128, BQ * 128, 1024));
      }
      wgmma_commit();
      turn_end();
      wgmma_wait<1>();
      mbar_arrive(empty_do + st);  // dV has read dO; lse and delta were read before
      wgmma_wait<0>();
      mbar_arrive(empty_q + st);
    }

    // epilogue: dK and dV in bf16 into this warpgroup's rows of the K and V
    // tiles (only its own products read them, and all are done), in the
    // swizzle; then one TMA store each, which drops rows >= skv
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = 64 * wg + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);  // in the tile
      const int col = 8 * (i / 4) + col0;
      const int cc = col % 64;
      const int byte = (col / 64) * BKV * 128 + row * 128 + (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(k_s + byte) = pack_bf16(dk[i], dk[i + 1]);
      *reinterpret_cast<uint32_t*>(v_s + byte) = pack_bf16(dv[i], dv[i + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (tid == 0 && wg_first < skv) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_store(&maps.dk, k_s + c * BKV * 128 + 64 * wg * 128, 64 * c, wg_first, kv_row);
        tma_store(&maps.dv, v_s + c * BKV * 128 + 64 * wg * 128, 64 * c, wg_first, kv_row);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// The bf16 dQ tiles, the dK/dV's turned around: a CTA owns BQ query rows of
// one query row b * hq + h, 64 for each of two consumer warpgroups (the wgmma
// M), and walks kv tiles of BKV rows fed by one producer warpgroup. A
// consumer thread holds dQ (D / 2 fp32) and S and dP (BKV / 2 fp32 each):
// 160 data registers at D 64 and 192 at D 128, with no spill at either (kv
// tiles of 64 rows at D 128 ran the band dQ 8% slower).
template <int D>
struct Sm90Dq {
  static constexpr int BQ = 128;
  static constexpr int BKV = 128;
  static constexpr int STAGES = 2;              // the K/V ring
  static constexpr int kQBytes = BQ * D * 2;    // the Q or dO tile
  static constexpr int kKVBytes = BKV * D * 2;  // one K or V tile
  // Q, dO, the ring, 1024 bytes of slack to align the tiles to the
  // swizzle's 8 x 128-byte period, and the mbarriers: full for Q/dO, and per
  // stage full and empty for K and for V
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 2 * STAGES * kKVBytes + 8 * (1 + 4 * STAGES);
};

// The bf16 dQ's TMA maps: q and dO over [b * hq, sq, D] in boxes of BQ rows,
// k and v over [b * hkv, skv, D] in boxes of BKV rows, dq over [b * hq, sq, D]
// in boxes of 64 rows (a warpgroup's), all of 64 columns
struct DqMaps {
  CUtensorMap q, dout, k, v, dq;
};

// dQ for the q tile nq - 1 - blockIdx.y of query row blockIdx.x = b * hq + h
// (the grid runs q-tile-major, so the heaviest causal tiles, the last ones,
// start first). Shared memory holds this tile's Q and dO, loaded once, and a
// ring of STAGES K and V tiles, all in the 128-byte swizzle as [D / 64 column
// blocks][rows][64]. Each consumer warpgroup computes, for its 64 query
// rows, S = Q K^T and dP = dO V^T into registers, P and dS there, and
// dQ += dS K with the rounded dS as the register A operand; dQ stays in
// registers across all kv tiles and leaves once.
template <int D, typename M>
__device__ __forceinline__ void dq_tile_sm90(unsigned char* smem_raw, const DqMaps& maps,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, const M mask) {
  using C = Sm90Dq<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, S = C::STAGES;
  constexpr float kLog2e = 1.4426950408889634f;
  unsigned char* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* do_s = q_s + C::kQBytes;
  unsigned char* k_s = do_s + C::kQBytes;  // stage st at + st * kKVBytes
  unsigned char* v_s = k_s + S * C::kKVBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(v_s + S * C::kKVBytes);  // Q and dO
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;

  const int sq = mask.sq;
  const int bh = blockIdx.x;
  const int q_lo = ((sq + BQ - 1) / BQ - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int ik_begin = mask.kv_begin(q_lo, BKV);
  // with no kv tile (no key for these queries) nothing is loaded and dQ is 0
  const int n_tiles = max(0, mask.kv_end(q_lo, BQ, BKV) - ik_begin);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full_k + st, 1);
      mbar_init(full_v + st, 1);
      mbar_init(empty_k + st, 2 * 128);  // every consumer thread releases a buffer
      mbar_init(empty_v + st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: hands its registers to the consumers; one thread loads Q and
    // dO once and keeps up to S K/V tiles ahead of the consumers, K and V
    // released separately (dP is done with V before dQ += dS K with K)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * 128 && n_tiles > 0) {
      const int kv_row = bh / mask.groups();
      mbar_expect_tx(full_q, 2 * C::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(q_s + c * BQ * 128, &maps.q, full_q, 64 * c, q_lo, bh);
        tma_load(do_s + c * BQ * 128, &maps.dout, full_q, 64 * c, q_lo, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % S;
        const int k_lo = (ik_begin + it) * BKV;
        if (it >= S) mbar_wait(empty_k + st, (it / S - 1) & 1);  // the consumers released it
        mbar_expect_tx(full_k + st, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(k_s + st * C::kKVBytes + c * BKV * 128, &maps.k, full_k + st, 64 * c, k_lo, kv_row);
        }
        if (it >= S) mbar_wait(empty_v + st, (it / S - 1) & 1);
        mbar_expect_tx(full_v + st, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(v_s + st * C::kKVBytes + c * BKV * 128, &maps.v, full_v + st, 64 * c, k_lo, kv_row);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q_lo + 64 wg + [0, 64); this
    // thread holds rows row0 and row0 + 8 of S, dP and dQ, columns
    // 8 j + col0 + {0, 1} (the wgmma accumulator layout): keys of S and dP,
    // d of dQ
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const int wg_first = q_lo + 64 * wg, wg_last = wg_first + 63;
    const int row0 = wg_first + 16 * warp + lane / 4;
    const uint32_t q_addr = smem_addr(q_s) + 64 * wg * 128;  // this warpgroup's rows
    const uint32_t do_addr = smem_addr(do_s) + 64 * wg * 128;
    // the thread's two rows keep their -lse log2e and delta for the whole
    // CTA: loaded once, 0 past sq (those rows are never stored)
    float nl[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      const size_t at = static_cast<size_t>(bh) * sq + qi;
      nl[r] = qi < sq ? -lse[at] * kLog2e : 0.f;
      dl[r] = qi < sq ? delta[at] : 0.f;
    }
    float dq[D / 2], s[BKV / 2], dp[BKV / 2];
    uint32_t dsa[BKV / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = dp[i] = 0.f;
    // ping-pong: the two warpgroups take turns to issue their products
    // (named barriers 3 and 4), so one's exponentials and dS run under the
    // other's products; warpgroup 0 goes first
    auto turn_begin = [&]() { asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory"); };
    auto turn_end = [&]() { asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory"); };
    if (wg == 1) turn_end();
    if (n_tiles > 0) mbar_wait(full_q, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % S;
      const uint32_t parity = (it / S) & 1;
      const uint32_t k_addr = smem_addr(k_s) + st * C::kKVBytes;
      const uint32_t v_addr = smem_addr(v_s) + st * C::kKVBytes;
      const int k_lo = (ik_begin + it) * BKV;
      mbar_wait(full_k + st, parity);
      mbar_wait(full_v + st, parity);
      // S = Q K^T and dP = dO V^T: all K-major; a k16 step is 32 bytes into
      // a 64-column block
      turn_begin();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * BKV * 128 + (kk % 4) * 32;
        Wgmma<BKV>::ss(s, sw128_desc(q_addr + a_off, 16, 1024), sw128_desc(k_addr + b_off, 16, 1024),
                       kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * BKV * 128 + (kk % 4) * 32;
        Wgmma<BKV>::ss(dp, sw128_desc(do_addr + a_off, 16, 1024), sw128_desc(v_addr + b_off, 16, 1024),
                       kk > 0);
      }
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      mbar_arrive(empty_v + st);  // dP has read V

      // P = 2^(S log2e - lse log2e), exactly 0 where the mask drops the pair
      // (tested only on tiles that cut it: diagonal, window edge, ragged
      // end); dS = P (dP - delta), from the unrounded p
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] = fast_exp2(fmaf(s[i], kLog2e, nl[(i / 2) % 2]));
      if (!mask.keeps_all(wg_first, wg_last, k_lo, k_lo + BKV - 1)) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          if (!mask.keep(row0 + 8 * ((i / 2) % 2), k_lo + 8 * (i / 4) + col0 + i % 2)) s[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
      // dS rounded to bf16, the register A operand: the accumulator layout
      // matches the A fragment layout of m64k16
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) dsa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }

      // dQ += dS K: K is MN-major (transpose bit); a k16 step is 16 rows of
      // 128 bytes; LBO steps to the next 64-column block of D
      turn_begin();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        Wgmma<D>::rs(dq, dsa[kk], sw128_desc(k_addr + kk * 16 * 128, BKV * 128, 1024));
      }
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      mbar_arrive(empty_k + st);
    }

    // epilogue: dQ in bf16 into this warpgroup's rows of the Q tile (only
    // its own products read them, and all are done), in the swizzle; then
    // one TMA store, which drops rows >= sq
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = 64 * wg + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);  // in the tile
      const int col = 8 * (i / 4) + col0;
      const int cc = col % 64;
      const int byte = (col / 64) * BQ * 128 + row * 128 + (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(q_s + byte) = pack_bf16(dq[i], dq[i + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (tid == 0 && wg_first < sq) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_store(&maps.dq, q_s + c * BQ * 128 + 64 * wg * 128, 64 * c, wg_first, bh);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

static_assert(fwd_smem<float, 128>() <= kMaxSmem, "forward tile exceeds shared memory");
static_assert(dq_smem<float, 128>() <= kMaxSmem, "dQ tile exceeds shared memory");
static_assert(dkv_smem<float, 128>() <= kMaxSmem, "dK/dV tile exceeds shared memory");
static_assert(Sm90Dkv<64>::kSmem <= kMaxSmem && Sm90Dkv<128>::kSmem <= kMaxSmem,
              "bf16 dK/dV tile exceeds shared memory");
static_assert(Sm90Dq<64>::kSmem <= kMaxSmem && Sm90Dq<128>::kSmem <= kMaxSmem,
              "bf16 dQ tile exceeds shared memory");

// The kernels: one __global__ name per TPU kernel replaced, each a tile body
// under its family's mask.
// a kernel's threads: bf16 runs the sm_90a bodies (two consumer warpgroups
// and a producer warpgroup), fp32 the scalar ones
template <typename T>
struct BodyThreads {
  static constexpr int value = std::is_same_v<T, __nv_bfloat16> ? kSm90Threads : kThreads;
};

template <typename T, int D, typename M>
__device__ __forceinline__ void fwd_body(unsigned char* smem, const T* q, const T* k, const T* v, T* o,
                                         float* lse, const M mask, const FwdMaps& maps) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    fwd_tile_sm90<D>(smem, maps, lse, mask);
  } else {
    fwd_tile<T, D>(smem, q, k, v, o, lse, mask);
  }
}

template <typename T, int D, typename M>
__device__ __forceinline__ void dq_body(unsigned char* smem, const T* q, const T* k, const T* v,
                                        const T* dout, const float* lse, const float* delta, T* dq,
                                        const M mask, const DqMaps& maps) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    dq_tile_sm90<D>(smem, maps, lse, delta, mask);
  } else {
    dq_tile<T, D>(smem, q, k, v, dout, lse, delta, dq, mask);
  }
}

template <typename T, int D, typename M>
__device__ __forceinline__ void dkv_body(unsigned char* smem, const T* q, const T* k, const T* v,
                                         const T* dout, const float* lse, const float* delta, T* dk,
                                         T* dv, const M mask, const DkvMaps& maps) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    dkv_tile_sm90<D>(smem, maps, lse, delta, mask);
  } else {
    dkv_tile<T, D>(smem, q, k, v, dout, lse, delta, dk, dv, mask);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(BodyThreads<T>::value, 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, const Mask<CAUSAL, false> mask, const __grid_constant__ FwdMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_body<T, D>(smem, q, k, v, o, lse, mask, maps);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(BodyThreads<T>::value, 1) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, const Mask<CAUSAL, false> mask, const __grid_constant__ DqMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_body<T, D>(smem, q, k, v, dout, lse, delta, dq, mask, maps);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(BodyThreads<T>::value, 1) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const Mask<CAUSAL, false> mask,
    const __grid_constant__ DkvMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkv_body<T, D>(smem, q, k, v, dout, lse, delta, dk, dv, mask, maps);
}

template <typename T, int D>
__global__ void __launch_bounds__(BodyThreads<T>::value, 1) flash_band_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, const BandMask mask, const __grid_constant__ FwdMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_body<T, D>(smem, q, k, v, o, lse, mask, maps);
}

template <typename T, int D>
__global__ void __launch_bounds__(BodyThreads<T>::value, 1) flash_band_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, const BandMask mask, const __grid_constant__ DqMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_body<T, D>(smem, q, k, v, dout, lse, delta, dq, mask, maps);
}

template <typename T, int D>
__global__ void __launch_bounds__(BodyThreads<T>::value, 1) flash_band_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const BandMask mask,
    const __grid_constant__ DkvMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkv_body<T, D>(smem, q, k, v, dout, lse, delta, dk, dv, mask, maps);
}

// Launch arguments of the C entry points.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;  // o, dq or dk
  void* out1;  // dv
  float* lse_out;
  int bh;  // b * hq
  cudaStream_t stream;
};

enum class Kind { kFwd, kDq, kDkv };

template <typename K, typename... A>
cudaError_t run(K kernel, size_t smem, dim3 grid, int threads, cudaStream_t stream, A... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D, bool CAUSAL, bool BAND>
int launch(Kind kind, const Args& a, const Mask<CAUSAL, BAND> m) {
  using C = Tiles<T, D>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* out0 = static_cast<T*>(a.out0);
  T* out1 = static_cast<T*>(a.out1);
  const dim3 q_grid((m.sq + C::BQ - 1) / C::BQ, a.bh);
  const dim3 kv_grid((m.skv + C::BKV - 1) / C::BKV, a.bh / m.groups());
  cudaError_t err;
  if (kind == Kind::kFwd) {
    FwdMaps maps{};
    size_t smem = fwd_smem<T, D>();
    dim3 grid = q_grid;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      using F = Sm90Fwd<D>;
      const int bh_kv = a.bh / m.groups();
      CUresult r = bf16_map(&maps.q, q, D, m.sq, a.bh, F::BQ);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.k, k, D, m.skv, bh_kv, F::BKV);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.v, v, D, m.skv, bh_kv, F::BKV);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.o, out0, D, m.sq, a.bh, 64);  // a warpgroup's rows
      if (r != CUDA_SUCCESS) return static_cast<int>(r);
      smem = F::kSmem;
      int dev = 0, sms = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return static_cast<int>(e);
      maps.bh = a.bh;
      grid = dim3(std::min((m.sq + F::BQ - 1) / F::BQ * a.bh, sms));  // one CTA an SM
    }
    constexpr int threads = BodyThreads<T>::value;
    if constexpr (BAND) {
      err = run(flash_band_fwd_kernel<T, D>, smem, grid, threads, a.stream, q, k, v, out0,
                a.lse_out, m, maps);
    } else {
      err = run(flash_fwd_kernel<T, D, CAUSAL>, smem, grid, threads, a.stream, q, k, v, out0,
                a.lse_out, m, maps);
    }
  } else if (kind == Kind::kDq) {
    DqMaps maps{};
    size_t smem = dq_smem<T, D>();
    dim3 grid = q_grid;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      using F = Sm90Dq<D>;
      const int bh_kv = a.bh / m.groups();
      CUresult r = bf16_map(&maps.q, q, D, m.sq, a.bh, F::BQ);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.dout, dout, D, m.sq, a.bh, F::BQ);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.k, k, D, m.skv, bh_kv, F::BKV);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.v, v, D, m.skv, bh_kv, F::BKV);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.dq, out0, D, m.sq, a.bh, 64);  // a warpgroup's rows
      if (r != CUDA_SUCCESS) return static_cast<int>(r);
      smem = F::kSmem;
      grid = dim3(a.bh, (m.sq + F::BQ - 1) / F::BQ);  // q-tile-major: last (heavy) tiles first
    }
    constexpr int threads = BodyThreads<T>::value;
    if constexpr (BAND) {
      err = run(flash_band_dq_kernel<T, D>, smem, grid, threads, a.stream, q, k, v, dout, a.lse_in,
                a.delta, out0, m, maps);
    } else {
      err = run(flash_dq_kernel<T, D, CAUSAL>, smem, grid, threads, a.stream, q, k, v, dout,
                a.lse_in, a.delta, out0, m, maps);
    }
  } else {
    DkvMaps maps{};
    size_t smem = dkv_smem<T, D>();
    dim3 grid = kv_grid;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      using F = Sm90Dkv<D>;
      const int bh_kv = a.bh / m.groups();
      CUresult r = bf16_map(&maps.q, q, D, m.sq, a.bh, F::BQ);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.dout, dout, D, m.sq, a.bh, F::BQ);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.k, k, D, m.skv, bh_kv, F::BKV);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.v, v, D, m.skv, bh_kv, F::BKV);
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.dk, out0, D, m.skv, bh_kv, 64);  // a warpgroup's rows
      if (r == CUDA_SUCCESS) r = bf16_map(&maps.dv, out1, D, m.skv, bh_kv, 64);
      if (r != CUDA_SUCCESS) return static_cast<int>(r);
      smem = F::kSmem;
      grid = dim3(bh_kv, (m.skv + F::BKV - 1) / F::BKV);  // kv-tile-major: low (heavy) tiles first
    }
    constexpr int threads = BodyThreads<T>::value;
    if constexpr (BAND) {
      err = run(flash_band_dkv_kernel<T, D>, smem, grid, threads, a.stream, q, k, v, dout, a.lse_in,
                a.delta, out0, out1, m, maps);
    } else {
      err = run(flash_dkv_kernel<T, D, CAUSAL>, smem, grid, threads, a.stream, q, k, v, dout,
                a.lse_in, a.delta, out0, out1, m, maps);
    }
  }
  return static_cast<int>(err);
}

template <bool CAUSAL, bool BAND>
int dispatch(int device, int dtype, int head_dim, Kind kind, const Args& a,
             const Mask<CAUSAL, BAND> m) {
  if (a.bh <= 0 || m.sq <= 0 || m.skv <= 0 || m.groups_ <= 0 || a.bh % m.groups_ ||
      m.window_ < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(kind, a, m);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(kind, a, m);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(kind, a, m);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(kind, a, m);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the rectangular mask: all pairs, or keys <= i
int dispatch_rect(int device, int dtype, int head_dim, int causal, Kind kind, const Args& a,
                  int sq, int skv) {
  return causal ? dispatch(device, dtype, head_dim, kind, a, Mask<true, false>{sq, skv, 1, 0})
                : dispatch(device, dtype, head_dim, kind, a, Mask<false, false>{sq, skv, 1, 0});
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. Each returns cudaGetLastError() after
// its launch.
//
// The rectangular kernels: q, k, v, o, dO, dq, dk, dv are [bh, s, head_dim]
// (K/V at q's head count), lse and delta fp32 [bh, sq].
extern "C" int flash_attention_fwd(int device, void* stream, int dtype, int head_dim, int causal,
                                   const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int sq, int skv) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, static_cast<float*>(lse),
               bh, static_cast<cudaStream_t>(stream)};
  return dispatch_rect(device, dtype, head_dim, causal, Kind::kFwd, a, sq, skv);
}

extern "C" int flash_attention_dq(int device, void* stream, int dtype, int head_dim, int causal,
                                  const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, int bh, int sq,
                                  int skv) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, bh, static_cast<cudaStream_t>(stream)};
  return dispatch_rect(device, dtype, head_dim, causal, Kind::kDq, a, sq, skv);
}

extern "C" int flash_attention_dkv(int device, void* stream, int dtype, int head_dim, int causal,
                                   const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int bh, int sq, int skv) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dk, dv, nullptr, bh, static_cast<cudaStream_t>(stream)};
  return dispatch_rect(device, dtype, head_dim, causal, Kind::kDkv, a, sq, skv);
}

// The band kernels: bh = b * hq; groups = hq / hkv; window 0 means none (pure
// causal). q, o, dO, dq: [bh, s, head_dim]; k, v, dk, dv: [bh / groups, s,
// head_dim]; lse, delta: fp32 [bh, s].
extern "C" int flash_band_fwd(int device, void* stream, int dtype, int head_dim, const void* q,
                              const void* k, const void* v, void* o, void* lse, int bh, int s,
                              int groups, int window) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, static_cast<float*>(lse),
               bh, static_cast<cudaStream_t>(stream)};
  return dispatch(device, dtype, head_dim, Kind::kFwd, a, BandMask{s, s, groups, window});
}

extern "C" int flash_band_dq(int device, void* stream, int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, void* dq, int bh, int s, int groups, int window) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, bh, static_cast<cudaStream_t>(stream)};
  return dispatch(device, dtype, head_dim, Kind::kDq, a, BandMask{s, s, groups, window});
}

extern "C" int flash_band_dkv(int device, void* stream, int dtype, int head_dim, const void* q,
                              const void* k, const void* v, const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bh, int s, int groups,
                              int window) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dk, dv, nullptr, bh, static_cast<cudaStream_t>(stream)};
  return dispatch(device, dtype, head_dim, Kind::kDkv, a, BandMask{s, s, groups, window});
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

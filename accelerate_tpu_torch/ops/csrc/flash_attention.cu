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
// Both families run the same three tile bodies (fwd_tile, dq_tile,
// dkv_tile) under a `Mask` that says which (query i, key j) pairs attend:
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
// (q head in group, q tile) for dK/dV). Here one CTA owns one (b*hq, q tile)
// (forward, dQ) or one (b*hkv, kv tile) (dK/dV) and loops over the other axis
// itself, with its own loop bounds (`Mask`):
//   - forward and dQ: kv tiles from the first inside the window,
//     max(0, q_lo - W + 1) / BKV, to the diagonal (causal) or the end;
//   - dK/dV: each query head of the kv head's group in turn, and the q tiles
//     from the diagonal to the last whose window still reaches the tile,
//     min(nq - 1, (k_lo + BKV - 1 + W - 1) / BQ); dK and dV sum in fp32 in
//     the CTA and are written once, in kv-head shape, with no atomics and no
//     [b, hq, s, d] gradient to reduce afterwards.
// Nothing carries between CTAs. Tiles are 64 x 64 (32 x 64 for fp32 at
// D = 128, to fit shared memory). Every operand tile, the fp32 scores and the
// fp32 accumulators live in shared memory; products run from shared memory
// with nvcuda::wmma m16n16k16 bf16 tensor-core fragments (fp32 accumulation),
// or with scalar fp32 FMAs for fp32 inputs (TF32 would break the fp32 parity
// tolerance). A ragged last tile is zero-filled on load and masked, so any
// sequence length runs.
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
// The design keeps the s x s scores out of device memory (each K/V or Q/dO
// tile is read once per CTA that needs it, from L2 after the first), works
// only on tiles inside the mask, so band time scales with W and not s^2, and
// schedules the heaviest causal tiles first. It does not reach either bound:
// operands go through shared memory with synchronous loads and wmma rather
// than TMA and wgmma, and at bf16 d 64 a CTA takes about 72 KB (forward),
// 99 KB (dQ) and 116 KB (dK/dV) of shared memory, so 3, 2 and 1 CTAs share
// an SM.
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
//     transient;
//   - backward: p = exp(s - lse) recomputed; dS = p * (dP - delta) in fp32,
//     rounded to the input dtype before dS.K and dS^T.Q; p rounded before
//     P^T.dO. delta = rowsum(dO * O) comes in from the wrapper.
//
// Each C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a dtype, head_dim or shape it does not take; the
// Python wrapper (accelerate_tpu_torch/ops/flash_attention.py) raises if the
// code is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // what one CTA may use on sm_90

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float from_f(float x) { return x; }
  static __device__ __forceinline__ float to_f(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
};

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

// bf16 inputs: tensor cores through wmma 16x16x16 fragments with fp32
// accumulation; the warps take C's 16 x 16 sub-tiles in turn.
template <int M, int N, int K, bool A_T, bool B_T, bool ACC>
__device__ __forceinline__ void gemm(float* C, int ldc, const __nv_bfloat16* A, int lda,
                                     const __nv_bfloat16* B, int ldb) {
  using LayoutA = std::conditional_t<A_T, wmma::col_major, wmma::row_major>;
  using LayoutB = std::conditional_t<B_T, wmma::col_major, wmma::row_major>;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * (N / 16); t += kWarps) {
    const int tm = t / (N / 16);
    const int tn = t % (N / 16);
    float* c_ptr = C + tm * 16 * ldc + tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (ACC) {
      wmma::load_matrix_sync(c, c_ptr, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(c, 0.f);
    }
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> b;
      wmma::load_matrix_sync(a, A_T ? A + k * lda + tm * 16 : A + tm * 16 * lda + k, lda);
      wmma::load_matrix_sync(b, B_T ? B + tn * 16 * ldb + k : B + k * ldb + tn * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(c_ptr, c, ldc, wmma::mem_row_major);
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
        p_s[r * C::LDP + lane + 32 * j] = Cvt<T>::from_f(p);
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
      ob[(size_t)qi * D + c] = Cvt<T>::from_f(acc[r * C::LDA + c] / (l == 0.f ? 1.f : l));
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
      ds_s[r * C::LDP + c] = Cvt<T>::from_f(p * (dp_s[r * C::LDS + c] - delta_s[r]));
    }
    __syncthreads();
    gemm<BQ, D, BKV, false, false, true>(acc, C::LDA, ds_s, C::LDP, k_s, C::LDT);
  }
  __syncthreads();
  T* dqb = dq + bh * sq * D;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q_lo + r;
    if (qi < sq) dqb[(size_t)qi * D + c] = Cvt<T>::from_f(acc[r * C::LDA + c]);
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
        pr_s[r * C::LDP + c] = Cvt<T>::from_f(p);
      }
      __syncthreads();
      gemm<BKV, D, BQ, true, false, true>(dv_acc, C::LDA, pr_s, C::LDP, do_s, C::LDT);
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * BKV; i += kThreads) {
        const int r = i / BKV, c = i % BKV;
        pr_s[r * C::LDP + c] =
            Cvt<T>::from_f(p_s[r * C::LDS + c] * (dp_s[r * C::LDS + c] - delta_s[r]));
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
      dkb[(size_t)kj * D + c] = Cvt<T>::from_f(dk_acc[r * C::LDA + c]);
      dvb[(size_t)kj * D + c] = Cvt<T>::from_f(dv_acc[r * C::LDA + c]);
    }
  }
}

static_assert(fwd_smem<float, 128>() <= kMaxSmem, "forward tile exceeds shared memory");
static_assert(dq_smem<float, 128>() <= kMaxSmem, "dQ tile exceeds shared memory");
static_assert(dkv_smem<float, 128>() <= kMaxSmem, "dK/dV tile exceeds shared memory");
static_assert(dkv_smem<__nv_bfloat16, 128>() <= kMaxSmem, "dK/dV tile exceeds shared memory");

// The kernels: one __global__ name per TPU kernel replaced, each a tile body
// under its family's mask.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, const Mask<CAUSAL, false> mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_tile<T, D>(smem, q, k, v, o, lse, mask);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, const Mask<CAUSAL, false> mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_tile<T, D>(smem, q, k, v, dout, lse, delta, dq, mask);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const Mask<CAUSAL, false> mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkv_tile<T, D>(smem, q, k, v, dout, lse, delta, dk, dv, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_band_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, const BandMask mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_tile<T, D>(smem, q, k, v, o, lse, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_band_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, const BandMask mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_tile<T, D>(smem, q, k, v, dout, lse, delta, dq, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_band_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const BandMask mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkv_tile<T, D>(smem, q, k, v, dout, lse, delta, dk, dv, mask);
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
cudaError_t run(K kernel, size_t smem, dim3 grid, cudaStream_t stream, A... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
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
    constexpr size_t smem = fwd_smem<T, D>();
    if constexpr (BAND) {
      err = run(flash_band_fwd_kernel<T, D>, smem, q_grid, a.stream, q, k, v, out0, a.lse_out, m);
    } else {
      err = run(flash_fwd_kernel<T, D, CAUSAL>, smem, q_grid, a.stream, q, k, v, out0, a.lse_out,
                m);
    }
  } else if (kind == Kind::kDq) {
    constexpr size_t smem = dq_smem<T, D>();
    if constexpr (BAND) {
      err = run(flash_band_dq_kernel<T, D>, smem, q_grid, a.stream, q, k, v, dout, a.lse_in,
                a.delta, out0, m);
    } else {
      err = run(flash_dq_kernel<T, D, CAUSAL>, smem, q_grid, a.stream, q, k, v, dout, a.lse_in,
                a.delta, out0, m);
    }
  } else {
    constexpr size_t smem = dkv_smem<T, D>();
    if constexpr (BAND) {
      err = run(flash_band_dkv_kernel<T, D>, smem, kv_grid, a.stream, q, k, v, dout, a.lse_in,
                a.delta, out0, out1, m);
    } else {
      err = run(flash_dkv_kernel<T, D, CAUSAL>, smem, kv_grid, a.stream, q, k, v, dout, a.lse_in,
                a.delta, out0, out1, m);
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

// Fused tied LM head + cross-entropy, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels of accelerate_tpu/ops/fused_ce.py:
//   - fused_ce_fwd_kernel              <- `_fwd_kernel` (launched by `_lse_ll` through pl.pallas_call)
//   - fused_ce_bwd_kernel<T, false>    <- `_dh_kernel`  (launched by `_fused_bwd`)
//   - fused_ce_bwd_kernel<T, true>     <- `_dw_kernel`  (launched by `_fused_bwd`)
//
// Layout: h [N, e] and w [V, e] contiguous, one dtype (fp32 or bf16); labels
// int32 [N] (already safe: an ignored row carries 0 and a zero gradient);
// lse, ll, g_lse, g_ll fp32 [N]. dh [N, e] in h's dtype, dw [V, e] in w's.
// e is a multiple of 64; N and V are any positive counts.
//
// What each kernel computes, as the TPU kernels do, with logits = h . w^T in
// fp32 from the input-dtype operands and columns >= V masked to NEG_INF:
//   - forward: per row, lse = logsumexp over the vocab (online, m and l in
//     fp32; l == 0 gives lse = m + log 1) and ll = the logit of the label;
//   - dH = dlogits . W and dW = dlogits^T . H, with p = exp(logits - lse)
//     recomputed and dlogits = g_lse * p + g_ll * onehot(label) in fp32,
//     rounded to the operand dtype before the product, accumulated in fp32
//     and written once in the output dtype.
//
// What differs from the TPU kernels: on the TPU the reduction axis is the
// last, sequential grid axis (vocab for forward and dH, rows for dW) and the
// running state lives in VMEM scratch across grid steps. Here one CTA owns a
// tile of "own" rows (h rows for forward and dH, w rows for dW) and walks
// every tile of the "other" matrix itself, so nothing crosses CTAs and no
// atomics are needed. The reduction width is the model width e (768 for
// GPT-2 small), not a head dim: a 64 x e operand tile does not fit beside an
// fp32 accumulator in shared memory, so the logits tile is a k-loop over e in
// 64-wide chunks, double-buffered with cp.async (zero-filled past N or V, so
// w is read in place and never padded). The backward keeps its fp32
// accumulator [32 own rows, ES] in shared memory (ES <= 1024 columns of e:
// 129 KB); an e above 1024 is split over ceil(e / 1024) CTAs per row tile,
// each recomputing its logits. dlogits . other goes through the same chunked
// operand buffers. bf16 products run on tensor cores through nvcuda::wmma
// 16x16x16 fragments with fp32 accumulation (the logits' accumulators stay
// in registers across the k-loop); fp32 products run as scalar FMAs (TF32
// would break the fp32 tolerance).
//
// Bounds on an H100 SXM (NVIDIA data sheet: 3.35 TB/s HBM3, 989 TFLOP/s bf16
// dense) at GPT-2 small, N 8192, V 50257, e 768, bf16:
//   - forward: one product, 2 N V e = 632 GFLOP, 0.64 ms; bytes (h, w,
//     labels, lse, ll: 90 MB, 0.027 ms): bound by operations;
//   - dH, dW: two products each (the logits are recomputed from lse), 1.28 ms.
// The design reads w once per row tile and h once per vocab tile (from L2
// after the first), and the backward reads its other tile twice (logits, then
// the product); it does not reach the bound: synchronous wmma out of shared
// memory rather than wgmma, one or two CTAs per SM.
//
// Each C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a dtype or shape it does not take; the Python
// wrapper (accelerate_tpu_torch/ops/fused_ce.py) raises if the code is not 0.

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
constexpr int kBK = 64;          // e chunk of every product
constexpr int kMaxSlice = 1024;  // columns of e one backward CTA accumulates
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
};

// Tiles by element type: BO own rows per CTA, BW other rows per step.
template <typename T, bool BWD>
struct Tiles {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BO = BWD ? 32 : 64;
  static constexpr int BW = kBf16 ? 128 : 64;
  static constexpr int LDK = kBK + 16 / (int)sizeof(T);  // operand chunks [rows][LDK] in T
  static constexpr int LDS = BW + 4;                      // fp32 logits tile [BO][LDS]
  static constexpr int LDD = BW + 16 / (int)sizeof(T);    // rounded dlogits [BO][LDD] in T
};

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory layout of one CTA; the accumulator's size depends on the e
// slice, the rest on the tiles.
template <typename T, bool BWD>
struct Smem {
  using C = Tiles<T, BWD>;
  static constexpr size_t own = align128(sizeof(T) * C::BO * C::LDK);
  static constexpr size_t oth = align128(sizeof(T) * C::BW * C::LDK);
  static constexpr size_t stages = 2 * (own + oth);
  static constexpr size_t logits = align128(sizeof(float) * C::BO * C::LDS);
  static constexpr size_t dl = BWD ? align128(sizeof(T) * C::BO * C::LDD) : 0;
  static constexpr size_t vecs = align128(4 * 4 * (C::BO > C::BW ? C::BO : C::BW));
  static constexpr size_t fixed = stages + logits + dl + vecs;
  static constexpr size_t acc(int es) { return BWD ? sizeof(float) * C::BO * (es + 4) : 0; }
  static constexpr size_t total(int es) { return fixed + acc(es); }
};

static_assert(Smem<float, true>::total(kMaxSlice) <= 232448, "fp32 backward exceeds shared memory");
static_assert(Smem<__nv_bfloat16, true>::total(kMaxSlice) <= 232448,
              "bf16 backward exceeds shared memory");
static_assert(Smem<float, false>::total(0) <= 232448, "fp32 forward exceeds shared memory");

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

// 16 bytes global -> shared without registers; src_size 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// columns [k0, k0 + 64) of rows [row0, row0 + ROWS) of a contiguous [n_rows, e]
// matrix into shared memory (leading dim LD); rows >= n_rows are zero-filled
template <typename T, int ROWS, int LD>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int row0, int n_rows, int e,
                                           int k0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kBK / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? row0 + r : 0) * e + k0 + c, ok);
  }
}

// Accumulator of a [BO][BW] logits tile across the e chunks. bf16: wmma
// fragments, warps 2 x 4 over the tile; fp32: each thread owns a
// (BO/16) x (BW/16) block (columns strided by 16).
template <typename T, int BO, int BW, int LDK>
struct TileAcc {
  static constexpr int FM = BO / 32, FN = BW / 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[FM][FN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }

  // += A[BO][64] . B[BW][64]^T
  __device__ __forceinline__ void mma(const T* a_s, const T* b_s) {
    const int warp = threadIdx.x / 32;
    const int r0 = (warp / 4) * FM * 16, c0 = (warp % 4) * FN * 16;
#pragma unroll
    for (int k = 0; k < kBK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(a[i], a_s + (r0 + i * 16) * LDK + k, LDK);
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(b[j], b_s + (c0 + j * 16) * LDK + k, LDK);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* s, int lds) {
    const int warp = threadIdx.x / 32;
    const int r0 = (warp / 4) * FM * 16, c0 = (warp % 4) * FN * 16;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(s + (r0 + i * 16) * lds + c0 + j * 16, c[i][j], lds,
                                wmma::mem_row_major);
  }
};

template <int BO, int BW, int LDK>
struct TileAcc<float, BO, BW, LDK> {
  static constexpr int TM = BO / 16, TN = BW / 16;
  float c[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* a_s, const float* b_s) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = a_s[(ty * TM + i) * LDK + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = b_s[(tx + 16 * j) * LDK + k];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* s, int lds) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[(ty * TM + i) * lds + tx + 16 * j] = c[i][j];
  }
};

// s[BO][BW] = own[own0 : own0 + BO] . oth[oth0 : oth0 + BW]^T in fp32, over
// e in 64-wide chunks, loads of chunk k + 1 in flight while chunk k multiplies
template <typename T, bool BWD>
__device__ __forceinline__ void logits_tile(float* s, T* own_st, T* oth_st, const T* own, int own0,
                                            int n_own, const T* oth, int oth0, int n_oth, int e) {
  using C = Tiles<T, BWD>;
  constexpr int kOwn = C::BO * C::LDK, kOth = C::BW * C::LDK;
  TileAcc<T, C::BO, C::BW, C::LDK> acc;
  acc.zero();
  const int nk = e / kBK;
  __syncthreads();  // the stages' last readers are done
  load_chunk<T, C::BO, C::LDK>(own_st, own, own0, n_own, e, 0);
  load_chunk<T, C::BW, C::LDK>(oth_st, oth, oth0, n_oth, e, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < nk) {
      load_chunk<T, C::BO, C::LDK>(own_st + (1 - cur) * kOwn, own, own0, n_own, e, (kc + 1) * kBK);
      load_chunk<T, C::BW, C::LDK>(oth_st + (1 - cur) * kOth, oth, oth0, n_oth, e, (kc + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    acc.mma(own_st + cur * kOwn, oth_st + cur * kOth);
    __syncthreads();  // before the next iteration loads into this stage
  }
  acc.store(s, C::LDS);
}

// C[M][N] += A[M][K] . B[K][N], all in shared memory, A and B row-major.
// fp32: scalar FMAs, each thread owns a (M/16) x (N/16) block of C.
template <int M, int N, int K>
__device__ __forceinline__ void gemm_acc(float* c_s, int ldc, const float* a_s, int lda,
                                         const float* b_s, int ldb) {
  constexpr int TM = M / 16, TN = N / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = c_s[(ty * TM + i) * ldc + tx + j * 16];
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = a_s[(ty * TM + i) * lda + k];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = b_s[k * ldb + tx + j * 16];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) c_s[(ty * TM + i) * ldc + tx + j * 16] = acc[i][j];
}

// bf16: wmma fragments, the warps take C's 16 x 16 sub-tiles in turn
template <int M, int N, int K>
__device__ __forceinline__ void gemm_acc(float* c_s, int ldc, const __nv_bfloat16* a_s, int lda,
                                         const __nv_bfloat16* b_s, int ldb) {
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * (N / 16); t += kWarps) {
    const int tm = t / (N / 16), tn = t % (N / 16);
    float* c_ptr = c_s + tm * 16 * ldc + tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, c_ptr, ldc, wmma::mem_row_major);
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, a_s + tm * 16 * lda + k, lda);
      wmma::load_matrix_sync(b, b_s + k * ldb + tn * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(c_ptr, c, ldc, wmma::mem_row_major);
  }
}

// One CTA per 64-row tile of h; walks every vocab tile of w.
template <typename T>
__global__ void __launch_bounds__(kThreads) fused_ce_fwd_kernel(
    const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ labels,
    float* __restrict__ lse, float* __restrict__ ll, int n, int v, int e) {
  using C = Tiles<T, false>;
  using S = Smem<T, false>;
  constexpr int BO = C::BO, BW = C::BW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* own_st = reinterpret_cast<T*>(smem);
  T* oth_st = reinterpret_cast<T*>(smem + 2 * S::own);
  float* s_s = reinterpret_cast<float*>(smem + S::stages);
  float* m_s = reinterpret_cast<float*>(smem + S::stages + S::logits);
  float* l_s = m_s + BO;
  float* ll_s = l_s + BO;
  int* lab_s = reinterpret_cast<int*>(ll_s + BO);

  const int row0 = blockIdx.x * BO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = threadIdx.x; r < BO; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    ll_s[r] = 0.f;
    lab_s[r] = row0 + r < n ? labels[row0 + r] : -1;
  }
  const int nv = (v + BW - 1) / BW;
  for (int iv = 0; iv < nv; ++iv) {
    const int v0 = iv * BW;
    logits_tile<T, false>(s_s, own_st, oth_st, h, row0, n, w, v0, v, e);
    __syncthreads();
    // online logsumexp and the label's logit, one warp per row
    for (int r = warp; r < BO; r += kWarps) {
      float x[BW / 32];
      float mx = kNegInf, hit = 0.f;
      const int lab = lab_s[r];
#pragma unroll
      for (int j = 0; j < BW / 32; ++j) {
        const int col = v0 + lane + 32 * j;
        x[j] = col < v ? s_s[r * C::LDS + lane + 32 * j] : kNegInf;
        if (col == lab && col < v) hit = x[j];
        mx = fmaxf(mx, x[j]);
      }
      mx = warp_max(mx);
      hit = warp_sum(hit);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BW / 32; ++j) sum += expf(x[j] - m_new);
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_prev - m_new) + sum;
        m_s[r] = m_new;
        ll_s[r] += hit;
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BO; r += kThreads) {
    if (row0 + r < n) {
      const float l = l_s[r];
      lse[row0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
      ll[row0 + r] = ll_s[r];
    }
  }
}

// fp32 vectors of the rows [row0, row0 + rows) into shared memory; rows past
// n get zeros (label -1), so they add nothing
__device__ __forceinline__ void load_row_vecs(float* lse_s, float* glse_s, float* gll_s,
                                              int* lab_s, const float* lse, const float* glse,
                                              const float* gll, const int* labels, int row0,
                                              int rows, int n) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool ok = row0 + i < n;
    lse_s[i] = ok ? lse[row0 + i] : 0.f;
    glse_s[i] = ok ? glse[row0 + i] : 0.f;
    gll_s[i] = ok ? gll[row0 + i] : 0.f;
    lab_s[i] = ok ? labels[row0 + i] : -1;
  }
}

// DW false (dH): own = h rows, other = w (vocab), out [N, e] += dl . w.
// DW true (dW): own = w rows (vocab), other = h rows, out [V, e] += dl^T . h.
// One CTA per (32 own rows, slice of e); the logits tile is own . other^T, so
// for dW it is the transposed logits and the row vectors follow the other side.
template <typename T, bool DW>
__global__ void __launch_bounds__(kThreads) fused_ce_bwd_kernel(
    const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ glse, const float* __restrict__ gll,
    T* __restrict__ out, int n, int v, int e, int slice) {
  using C = Tiles<T, true>;
  using S = Smem<T, true>;
  constexpr int BO = C::BO, BW = C::BW;
  constexpr int kOth = BW * C::LDK;
  extern __shared__ __align__(128) unsigned char smem[];
  T* own_st = reinterpret_cast<T*>(smem);
  T* oth_st = reinterpret_cast<T*>(smem + 2 * S::own);
  float* s_s = reinterpret_cast<float*>(smem + S::stages);
  T* dl_s = reinterpret_cast<T*>(smem + S::stages + S::logits);
  float* lse_s = reinterpret_cast<float*>(smem + S::stages + S::logits + S::dl);
  constexpr int kVec = BO > BW ? BO : BW;
  float* glse_s = lse_s + kVec;
  float* gll_s = glse_s + kVec;
  int* lab_s = reinterpret_cast<int*>(gll_s + kVec);
  float* acc = reinterpret_cast<float*>(smem + S::fixed);

  const T* own = DW ? w : h;
  const T* oth = DW ? h : w;
  const int n_own = DW ? v : n, n_oth = DW ? n : v;
  const int own0 = blockIdx.x * BO;
  const int c0 = blockIdx.y * slice;
  const int es = min(slice, e - c0);
  const int lda = slice + 4;

  for (int i = threadIdx.x; i < BO * lda; i += kThreads) acc[i] = 0.f;
  if (!DW) load_row_vecs(lse_s, glse_s, gll_s, lab_s, lse, glse, gll, labels, own0, BO, n);

  const int nt = (n_oth + BW - 1) / BW;
  for (int it = 0; it < nt; ++it) {
    const int oth0 = it * BW;
    logits_tile<T, true>(s_s, own_st, oth_st, own, own0, n_own, oth, oth0, n_oth, e);
    if (DW) load_row_vecs(lse_s, glse_s, gll_s, lab_s, lse, glse, gll, labels, oth0, BW, n);
    __syncthreads();
    // dl = g_lse * exp(logits - lse) + g_ll * onehot(label), rounded to T
    for (int i = threadIdx.x; i < BO * BW; i += kThreads) {
      const int o = i / BW, c = i % BW;
      const int r = DW ? c : o;                          // row of h, local to its vector
      const int row = DW ? oth0 + c : own0 + o;          // row of h
      const int col = DW ? own0 + o : oth0 + c;          // vocab entry
      float d = 0.f;
      if (row < n && col < v) {
        const float x = s_s[o * C::LDS + c];
        d = glse_s[r] * expf(x - lse_s[r]);
        if (col == lab_s[r]) d += gll_s[r];
      }
      dl_s[o * C::LDD + c] = Cvt<T>::from_f(d);
    }
    // acc[:, chunk] += dl . other[:, c0 + chunk], the other's chunks streamed
    const int nj = es / kBK;
    __syncthreads();
    load_chunk<T, BW, C::LDK>(oth_st, oth, oth0, n_oth, e, c0);
    cp_async_commit();
    for (int j = 0; j < nj; ++j) {
      const int cur = j & 1;
      if (j + 1 < nj) {
        load_chunk<T, BW, C::LDK>(oth_st + (1 - cur) * kOth, oth, oth0, n_oth, e,
                                  c0 + (j + 1) * kBK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      gemm_acc<BO, kBK, BW>(acc + j * kBK, lda, dl_s, C::LDD, oth_st + cur * kOth, C::LDK);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < BO * es; i += kThreads) {
    const int o = i / es, c = i % es;
    if (own0 + o < n_own) out[(size_t)(own0 + o) * e + c0 + c] = Cvt<T>::from_f(acc[o * lda + c]);
  }
}

struct Args {
  const void* h;
  const void* w;
  const int* labels;
  const float* lse_in;
  const float* glse;
  const float* gll;
  void* out;  // dh or dw
  float* lse_out;
  float* ll_out;
  int n, v, e;
  cudaStream_t stream;
};

enum class Kind { kFwd, kDh, kDw };

template <typename T, bool DW>
int launch_bwd(const Args& a) {
  using C = Tiles<T, true>;
  const int slices = (a.e + kMaxSlice - 1) / kMaxSlice;
  const int slice = ((a.e / kBK + slices - 1) / slices) * kBK;
  const size_t smem = Smem<T, true>::total(slice);
  auto kernel = fused_ce_bwd_kernel<T, DW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<T, true>::total(kMaxSlice));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_own = DW ? a.v : a.n;
  const dim3 grid((n_own + C::BO - 1) / C::BO, (a.e + slice - 1) / slice);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.h), static_cast<const T*>(a.w), a.labels, a.lse_in, a.glse, a.gll,
      static_cast<T*>(a.out), a.n, a.v, a.e, slice);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(Kind kind, const Args& a) {
  if (a.n <= 0 || a.v <= 0 || a.e <= 0 || a.e % kBK) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == Kind::kFwd) {
    using C = Tiles<T, false>;
    constexpr size_t smem = Smem<T, false>::total(0);
    auto kernel = fused_ce_fwd_kernel<T>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.n + C::BO - 1) / C::BO);
    kernel<<<grid, kThreads, smem, a.stream>>>(static_cast<const T*>(a.h),
                                               static_cast<const T*>(a.w), a.labels, a.lse_out,
                                               a.ll_out, a.n, a.v, a.e);
    return static_cast<int>(cudaGetLastError());
  }
  return kind == Kind::kDh ? launch_bwd<T, false>(a) : launch_bwd<T, true>(a);
}

int dispatch(int device, int dtype, Kind kind, const Args& a) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  switch (dtype) {
    case 0: return launch<float>(kind, a);
    case 1: return launch<__nv_bfloat16>(kind, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. h [n, e], w [v, e] contiguous, labels
// int32 [n], row vectors fp32 [n]. Each returns cudaGetLastError() after its launch.
extern "C" int fused_ce_fwd(int device, void* stream, int dtype, const void* h, const void* w,
                            const void* labels, void* lse, void* ll, int n, int v, int e) {
  const Args a{h, w, static_cast<const int*>(labels), nullptr, nullptr, nullptr, nullptr,
               static_cast<float*>(lse), static_cast<float*>(ll), n, v, e,
               static_cast<cudaStream_t>(stream)};
  return dispatch(device, dtype, Kind::kFwd, a);
}

extern "C" int fused_ce_dh(int device, void* stream, int dtype, const void* h, const void* w,
                           const void* labels, const void* lse, const void* glse,
                           const void* gll, void* dh, int n, int v, int e) {
  const Args a{h, w, static_cast<const int*>(labels), static_cast<const float*>(lse),
               static_cast<const float*>(glse), static_cast<const float*>(gll), dh, nullptr,
               nullptr, n, v, e, static_cast<cudaStream_t>(stream)};
  return dispatch(device, dtype, Kind::kDh, a);
}

extern "C" int fused_ce_dw(int device, void* stream, int dtype, const void* h, const void* w,
                           const void* labels, const void* lse, const void* glse,
                           const void* gll, void* dw, int n, int v, int e) {
  const Args a{h, w, static_cast<const int*>(labels), static_cast<const float*>(lse),
               static_cast<const float*>(glse), static_cast<const float*>(gll), dw, nullptr,
               nullptr, n, v, e, static_cast<cudaStream_t>(stream)};
  return dispatch(device, dtype, Kind::kDw, a);
}

extern "C" const char* fused_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

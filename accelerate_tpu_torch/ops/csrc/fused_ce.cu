// Fused tied LM head + cross-entropy, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels of accelerate_tpu/ops/fused_ce.py:
//   - fused_ce_fwd_kernel                 <- `_fwd_kernel` (launched by `_lse_ll`,
//                                            through pl.pallas_call)
//   - fused_ce_bwd_kernel<T, false, ...>  <- `_dh_kernel`  (launched by `_fused_bwd`)
//   - fused_ce_bwd_kernel<T, true, ...>   <- `_dw_kernel`  (launched by `_fused_bwd`)
//
// Layout: h [N, e] and w [V, e] contiguous, one dtype (fp32 or bf16); labels
// int32 [N] (already safe: an ignored row carries 0 and a zero gradient);
// lse, ll, g_lse, g_ll fp32 [N]. dh [N, e] in h's dtype, dw [V, e] in w's.
// e is a multiple of 64; N and V are any positive counts.
//
// What each kernel computes, as the TPU kernels do, with logits = h . w^T in
// fp32 from the input-dtype operands and columns >= V masked out:
//   - forward: per row, lse = logsumexp over the vocab (online, m and l in
//     fp32; l == 0 gives lse = m + log 1) and ll = the logit of the label;
//   - dH = dlogits . W and dW = dlogits^T . H, with p = exp(logits - lse)
//     recomputed and dlogits = g_lse * p + g_ll * onehot(label) in fp32,
//     rounded to the operand dtype before the product, accumulated in fp32
//     and written once in the output dtype. No atomics: two launches give
//     equal bits.
//
// What differs from the TPU kernels: on the TPU the reduction axis is the
// last, sequential grid axis (vocab for forward and dH, rows for dW) and the
// running state lives in VMEM scratch across grid steps. Here one CTA owns a
// tile of "own" rows (h rows for forward and dH, w rows for dW) and walks
// every tile of the "other" matrix itself, so nothing crosses CTAs. The
// reduction depth of the logits and the width of dH and dW are both the model
// width e (768 for GPT-2 small), not a head dim.
//
// The bf16 backward (bwd_tile_sm90, both fused_ce_bwd_kernel<bf16, DW, NH>):
//   - a CTA owns 64 own rows and one slice of e's output columns: e's
//     64-column chunks are dealt into C = ceil(e / 512) slices (384 + 384 at
//     e 768); the grid is (own tiles rounded up to the cluster, C). Each
//     slice's CTA recomputes the logits over the full e, so the kernel runs
//     C + 1 products where the bound counts 2: 3 at e 768, 1.5x the bound's
//     work;
//   - clusters of 2 CTAs along the own axis (same slice) walk the same other
//     tiles: each other chunk [128 rows, 64 columns] reaches both from one
//     TMA multicast per CTA, each loading 64 of its rows; a stage is refilled
//     only when the consumers of both CTAs have released it (remote mbarrier
//     arrivals); no CTA leaves before the cluster's last barrier, and a
//     padding tile runs on zero-filled rows and stores nothing;
//   - a producer warpgroup (setmaxnreg 40) runs an 8-stage TMA ring of 24 KB
//     stages, per other tile first the e chunks that S needs, each beside the
//     own tile's chunk of the same columns (unicast), then the slice's other
//     chunks again for the product. The own tile streams rather than staying
//     resident: at equal ring depth the two ran alike, and the shared memory
//     a resident [64, e] tile takes (96 KB at e 768) bought a deeper ring,
//     which ran faster (PERF.md, PR 10). For dW its threads stage each other tile's 128
//     row vectors (lse pre-scaled by log2e, g_lse, g_ll, label), one row a
//     thread, loaded before the buffer wait;
//   - two consumer warpgroups (setmaxnreg 232) both take the CTA's 64 own
//     rows. Each computes S for its 64 of the tile's 128 other rows by
//     wgmma (m64n64k16, both operands K-major in shared memory) into 32
//     registers, chunk by chunk with one chunk's products in flight; forms
//     dl there (ex2 in base 2; dH keeps its two rows' vectors in registers,
//     dW reads the staged ones; vocab columns past V give exactly 0); and
//     writes dl in bf16, in the 128-byte swizzle, into its half of a shared
//     [64, 128] dl tile. After a named barrier over both, each adds
//     dl . other to its half of the slice's output chunks (wgmma, dl
//     K-major, the other chunk MN-major through the transpose bit). The
//     halves are disjoint, so no sum crosses warpgroups; the output stays in
//     fp32 registers (at most 4 chunks, 128 a thread) across all other tiles
//     and leaves by TMA stores from the ring, rows past the own count
//     dropped. A warpgroup with fewer chunks than the launch's most runs its
//     last product into an accumulator it never stores, so every wgmma is
//     issued unconditionally.
// The fp32 backward and both forwards keep the first design: the logits tile
// is a k-loop over e in 64-wide chunks, double-buffered with cp.async; the
// fp32 backward keeps its accumulator [32 own rows, <= 1024 columns of e] in
// shared memory; bf16 forward products run on nvcuda::wmma 16x16x16
// fragments, fp32 products as scalar FMAs (TF32 would break the fp32
// tolerance).
//
// Bounds on an H100 SXM (NVIDIA data sheet: 3.35 TB/s HBM3, 989 TFLOP/s bf16
// dense) at GPT-2 small, N 8192, V 50257, e 768, bf16:
//   - forward: one product, 2 N V e = 632 GFLOP, 0.64 ms; bytes (h, w,
//     labels, lse, ll: 90 MB, 0.027 ms): bound by operations;
//   - dH, dW: two products each (the logits are recomputed from lse),
//     1.264 TFLOP, 1.279 ms; bound by operations.
// What holds the bf16 backward from its bound: the third product (C + 1 =
// 3); shared-memory bandwidth, since both m64n64k16 products read both
// operands from shared memory (4 KB a wgmma, the SM's 128 bytes a clock at
// the tensor cores' rate) while TMA writes each stage beside them; and the
// ring's latency, which its depth only partly hides.
//
// Each C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a dtype or shape it does not take; the Python
// wrapper (accelerate_tpu_torch/ops/fused_ce.py) raises if the code is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"  // mbarriers, TMA (multicast too), wgmma, clusters, tensor maps

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;          // e chunk of every product
constexpr int kMaxSlice = 1024;  // columns of e one fp32 backward CTA accumulates
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float from_f(float x) { return x; }
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

static_assert(Smem<float, true>::total(kMaxSlice) <= kMaxSmem,
              "fp32 backward exceeds shared memory");
static_assert(Smem<float, false>::total(0) <= kMaxSmem, "fp32 forward exceeds shared memory");

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

// The fp32 backward. DW false (dH): own = h rows, other = w (vocab),
// out [N, e] += dl . w. DW true (dW): own = w rows (vocab), other = h rows,
// out [V, e] += dl^T . h. One CTA per (32 own rows, slice of e); the logits
// tile is own . other^T, so for dW it is the transposed logits and the row
// vectors follow the other side.
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

// ------------------------------------------------ the bf16 backward on sm_90a

constexpr int kCluster = 2;      // CTAs of a cluster, along the own axis
constexpr int kStages = 8;       // the TMA ring
constexpr int kSliceChunks = 8;  // 64-column chunks of e one CTA outputs: 512 columns
constexpr int kSpanChunks = 4;   // chunks of S one wgmma accumulator chain sums

// The bf16 backward's tiles: a CTA owns BM own rows and one slice of e's
// columns, and walks the other matrix in tiles of BN rows, 64 for each of two
// consumer warpgroups; a producer warpgroup feeds them.
struct Sm90Bwd {
  static constexpr int BM = 64;
  static constexpr int BN = 128;
  static constexpr int kThreads = 3 * 128;
  static constexpr int kOwnChunk = BM * 128;  // bytes of [64 rows][64 columns] in bf16
  static constexpr int kOthChunk = BN * 128;  // [128 rows][64 columns]
  static constexpr int kStage = kOthChunk + kOwnChunk;  // a ring stage: other chunk, own chunk
  static constexpr int kVecBytes = 4 * BN * 4;  // a tile's -lse log2e, g_lse, g_ll and label
  // 1024 bytes of slack to align the tiles to the swizzle's 8 x 128-byte
  // period; the ring; the dl tile [2 column blocks][64][64]; two tiles'
  // vectors (dW); the mbarriers: full and empty per stage, full and empty per
  // vector buffer
  static constexpr size_t kSmem =
      1024 + kStages * kStage + 2 * kOwnChunk + 2 * kVecBytes + 8 * (2 * kStages + 4);
};

static_assert(Sm90Bwd::kSmem <= kMaxSmem, "bf16 backward exceeds shared memory");
static_assert(kStages * Sm90Bwd::kStage >= kSliceChunks * Sm90Bwd::kOwnChunk,
              "the ring cannot stage a slice's output");

// The bf16 backward's launch: TMA maps over own [n_own, e] (boxes of 64 rows),
// other [n_oth, e] (boxes of BN / kCluster rows, one CTA's multicast share)
// and out [n_own, e] (boxes of 64 rows), all of 64 columns; the row vectors
// (of h's rows: the own rows for dH, the other rows for dW); e's 64-column
// chunks and the slices they are dealt into (blockIdx.y)
struct BwdParams {
  CUtensorMap own, oth, out;
  const int* labels;
  const float* lse;
  const float* glse;
  const float* gll;
  int n, v, nk, slices;
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// out[own rows, slice] = dl . other[:, slice] over all other tiles, with
// S = own . other^T and dl = g_lse exp(S - lse) + g_ll onehot(label) rounded
// to bf16. DW false (dH): own = h, other = w, the vectors follow the own
// rows. DW true (dW): own = w, other = h, the vectors follow the other rows.
// CTA (blockIdx.x, blockIdx.y) owns own rows 64 blockIdx.x + [0, 64) and
// slice blockIdx.y of e; the CTAs of a cluster (kCluster consecutive own
// tiles, one slice) walk the same other tiles, and each other chunk reaches
// all of them from one multicast TMA load per CTA, each loading BN / kCluster
// of its rows. Per other tile the ring carries the nk chunks of e that S
// needs, each beside the own tile's chunk of the same columns (loaded by each
// CTA for itself), then the slice's other chunks again for the product. A
// consumer warpgroup computes S for its 64 other rows into registers, writes
// its half of the dl tile to shared memory, and, once both halves are there,
// adds dl . other to its half of the slice's output chunks, which stay in
// fp32 registers (NH chunks at most, 32 a thread each) across all other
// tiles.
template <bool DW, int NH>
__device__ __forceinline__ void bwd_tile_sm90(unsigned char* smem_raw, const BwdParams& p) {
  using C = Sm90Bwd;
  constexpr int S = kStages, CL = kCluster, BN = C::BN;
  constexpr int kShare = BN / CL;  // other rows each CTA of the cluster loads for all
  constexpr float kLog2e = 1.4426950408889634f;
  const int nk = p.nk;
  // stage st at ring + st * kStage: the other chunk, then the own chunk
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* dl_s = ring + S * C::kStage;
  float* vec_s = reinterpret_cast<float*>(dl_s + 2 * C::kOwnChunk);  // [2][4][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(vec_s + 2 * 4 * BN);
  uint64_t* empty = full + S;
  uint64_t* full_vec = empty + S;
  uint64_t* empty_vec = full_vec + 2;

  const int own0 = blockIdx.x * C::BM;
  const int n_own = DW ? p.v : p.n, n_oth = DW ? p.n : p.v;
  const int nt = (n_oth + BN - 1) / BN;
  // this CTA's slice: e's chunks [chunk0, chunk0 + nsl), dealt evenly;
  // warpgroup 0 outputs the slice's chunks [0, h0), warpgroup 1 [h0, nsl)
  const int per = nk / p.slices, extra = nk % p.slices, y = blockIdx.y;
  const int nsl = per + (y < extra);
  const int chunk0 = y * per + min(y, extra);
  const int h0 = (nsl + 1) / 2;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 8 * CL);  // every consumer warp of every CTA of the cluster
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(full_vec + b, 128);  // every producer thread writes a row
      mbar_init(empty_vec + b, 8);   // every consumer warp has read them
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before a multicast or remote arrival

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: hands its registers to the consumers. Thread 0 runs the
    // ring, each stage refilled once the consumers of every CTA of the
    // cluster have released it; for dW each thread also stages row
    // oth0 + pt of each other tile's vectors, loaded before it waits for the
    // buffer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - 2 * 128;
    const uint32_t rank = cluster_ctarank();
    int fill = 0;
    for (int t = 0; t < nt && (DW || pt == 0); ++t) {
      const int oth0 = t * BN;
      if (DW) {
        const int row = oth0 + pt;
        const bool ok = row < p.n;
        const float nl = ok ? -p.lse[row] * kLog2e : 0.f;
        const float gs = ok ? p.glse[row] : 0.f;
        const float gl = ok ? p.gll[row] : 0.f;
        const int lab = ok ? p.labels[row] : -1;
        const int b = t & 1;
        if (t >= 2) mbar_wait(empty_vec + b, ((t >> 1) - 1) & 1);
        float* v = vec_s + b * 4 * BN;
        v[pt] = nl;
        v[BN + pt] = gs;
        v[2 * BN + pt] = gl;
        reinterpret_cast<int*>(v)[3 * BN + pt] = lab;
        mbar_arrive(full_vec + b);
      }
      if (pt != 0) continue;
      for (int q = 0; q < nk + nsl; ++q, ++fill) {
        const int st = fill % S;
        const bool s_chunk = q < nk;  // S's chunks first, then the slice's
        const int col = 64 * (s_chunk ? q : chunk0 + q - nk);
        unsigned char* dst = ring + st * C::kStage;
        if (fill >= S) mbar_wait(empty + st, (fill / S - 1) & 1);
        mbar_expect_tx(full + st, C::kOthChunk + (s_chunk ? C::kOwnChunk : 0));
        tma_load_multicast(dst + rank * kShare * 128, &p.oth, full + st, col,
                           oth0 + rank * kShare, 0, static_cast<uint16_t>((1 << CL) - 1));
        if (s_chunk) tma_load(dst + C::kOthChunk, &p.own, full + st, col, own0, 0);
      }
    }
  } else {
    // consumers: both warpgroups take the CTA's 64 own rows; this thread
    // holds rows r0 and r0 + 8 of S and of the output chunks, columns
    // 8 j + col0 + {0, 1} (the wgmma accumulator layout); S's columns are
    // the other rows 64 wg + [0, 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const int r0 = 16 * warp + lane / 4;
    const int lo = wg == 0 ? 0 : h0, hi = wg == 0 ? h0 : nsl;  // this warpgroup's chunks
    // dH: the thread's two own rows are h's: their vectors, loaded once (0
    // and label -1 past N, so those rows' dl is 0)
    float nl[2] = {0.f, 0.f}, gs[2] = {0.f, 0.f}, gl[2] = {0.f, 0.f};
    int lab[2] = {-1, -1};
    if (!DW) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = own0 + r0 + 8 * r;
        if (row < p.n) {
          nl[r] = -p.lse[row] * kLog2e;
          gs[r] = p.glse[row];
          gl[r] = p.gll[row];
          lab[r] = p.labels[row];
        }
      }
    }
    float s[32], sp[32], out[NH][32];
#pragma unroll
    for (int c = 0; c < NH; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) out[c][i] = 0.f;
    }
    // a stage's release: each warp arrives once on the stage's empty barrier
    // of every CTA of the cluster
    auto release = [&](int f) {
      __syncwarp();
      if (lane < CL) mbar_arrive_cluster(empty + f % S, lane);
    };
    auto wait_full = [&](int f) { mbar_wait(full + f % S, (f / S) & 1); };
    const uint32_t ring_addr = smem_addr(ring), dl_addr = smem_addr(dl_s);

    int fill = 0;
    for (int t = 0; t < nt; ++t) {
      const int oth0 = t * BN;
      // S = own . other^T over e's chunks, both K-major (a k16 step is 32
      // bytes into a chunk), the next chunk's products issued while the last
      // chunk's run; a chunk's stage is released once its products are done.
      // The tensor cores' fp32 sums lose bits over a long chain, so the
      // products of each span of kSpanChunks chunks (256 columns of e) sum in
      // sp, and the spans add into s with rounded fp32 adds
      for (int kc = 0; kc < nk; ++kc) {
        const int f = fill + kc;
        const uint32_t st_addr = ring_addr + (f % S) * C::kStage;
        const uint32_t a_addr = st_addr + C::kOthChunk;
        const uint32_t b_addr = st_addr + 64 * wg * 128;
        const bool span_end = kc % kSpanChunks == kSpanChunks - 1 || kc == nk - 1;
        wait_full(f);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          Wgmma<64>::ss(sp, sw128_desc(a_addr + kk * 32, 16, 1024),
                        sw128_desc(b_addr + kk * 32, 16, 1024), kc % kSpanChunks > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (kc % kSpanChunks > 0) release(f - 1);  // else released at the last span's end
        if (span_end) {
          wgmma_wait<0>();
          release(f);
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = kc < kSpanChunks ? sp[i] : s[i] + sp[i];
        }
      }
      fill += nk;

      // with fewer chunks of e than ring stages, the ring does not order the
      // other warpgroup's last products (they read the whole dl tile) before
      // this warpgroup's next dl: a barrier does
      if (nk < S && t > 0) bar_sync(2, 256);
      // dl = g_lse 2^(S log2e - lse log2e) + g_ll [column is the label],
      // rounded to bf16 into this warpgroup's column block of the dl tile
      // (K-major for the product, in the swizzle); exactly 0 on vocab
      // columns past V (dH: other rows TMA read as 0)
      if (DW) mbar_wait(full_vec + (t & 1), (t >> 1) & 1);
      const float* vec = vec_s + (t & 1) * 4 * BN + 64 * wg;
      const bool ragged = !DW && oth0 + BN > p.v;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + col0;  // in the warpgroup's 64 columns
        float2 vnl = make_float2(0.f, 0.f), vgs = vnl, vgl = vnl;
        int2 vlab = make_int2(-1, -1);
        if (DW) {
          vnl = *reinterpret_cast<const float2*>(vec + c);
          vgs = *reinterpret_cast<const float2*>(vec + BN + c);
          vgl = *reinterpret_cast<const float2*>(vec + 2 * BN + c);
          vlab = *reinterpret_cast<const int2*>(vec + 3 * BN + c);
        }
#pragma unroll
        for (int e2 = 0; e2 < 4; ++e2) {
          const int i = 4 * j + e2, r = e2 / 2, cc = e2 % 2;
          float x;
          if (DW) {
            const int vocab = own0 + r0 + 8 * r;
            x = (cc ? vgs.y : vgs.x) * fast_exp2(fmaf(s[i], kLog2e, cc ? vnl.y : vnl.x));
            if (vocab == (cc ? vlab.y : vlab.x)) x += cc ? vgl.y : vgl.x;
          } else {
            const int vocab = oth0 + 64 * wg + c + cc;
            x = gs[r] * fast_exp2(fmaf(s[i], kLog2e, nl[r]));
            if (vocab == lab[r]) x += gl[r];
            if (ragged && vocab >= p.v) x = 0.f;
          }
          s[i] = x;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          const int byte = wg * C::kOwnChunk + row * 128 + ((j ^ (row % 8)) * 16) + col0 * 2;
          *reinterpret_cast<uint32_t*>(dl_s + byte) =
              pack_bf16(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
        }
      }
      if (DW) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_vec + (t & 1));
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_sync(1, 256);  // both halves of the dl tile are written

      // out[:, chunk] += dl . other[:, chunk] for this warpgroup's chunks of
      // the slice: dl K-major (a k16 step is 32 bytes into a column block of
      // 64), the other chunk MN-major through the transpose bit (a k16 step
      // is 16 rows of 128 bytes). A stage the other warpgroup reads is
      // released once it is full. A warpgroup with fewer than NH chunks runs
      // its last product on the dl tile into an accumulator it never stores,
      // so that every product is issued unconditionally
      if (wg == 1) {
        for (int j = 0; j < lo; ++j) {
          wait_full(fill + j);
          release(fill + j);
        }
      }
#pragma unroll
      for (int jj = 0; jj < NH; ++jj) {
        const int j = lo + jj;
        uint32_t b_addr = dl_addr;
        if (j < hi) {
          wait_full(fill + j);
          b_addr = ring_addr + ((fill + j) % S) * C::kStage;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t a_addr = dl_addr + (kk / 4) * C::kOwnChunk + (kk % 4) * 32;
          Wgmma<64>::ss<1>(out[jj], sw128_desc(a_addr, 16, 1024),
                           sw128_desc(b_addr + kk * 16 * 128, C::kOthChunk, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (jj > 0 && j - 1 < hi) release(fill + j - 1);
      }
      // the next tile's S waits for this one's products: issuing it under the
      // last product group ran slower
      wgmma_wait<0>();
      if (lo + NH - 1 < hi) release(fill + lo + NH - 1);
      if (wg == 0) {
        for (int j = hi; j < nsl; ++j) {
          wait_full(fill + j);
          release(fill + j);
        }
      }
      fill += nsl;
    }

    // epilogue: once no product of either warpgroup reads the ring, each
    // writes its chunks in bf16 into the ring (every stage is consumed), in
    // the swizzle, and one thread stores them by TMA (rows >= n_own dropped;
    // a cluster's padding tile stores nothing)
    bar_sync(3, 256);
#pragma unroll
    for (int jj = 0; jj < NH; ++jj) {
      if (lo + jj < hi) {
        unsigned char* slot = ring + (lo + jj) * C::kOwnChunk;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = r0 + 8 * ((i / 2) % 2);
          const int col = 8 * (i / 4) + col0;
          const int byte = row * 128 + (((col / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
          *reinterpret_cast<uint32_t*>(slot + byte) = pack_bf16(out[jj][i], out[jj][i + 1]);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(4 + wg, 128);
    if (tid == 0 && own0 < n_own) {
      for (int j = lo; j < hi; ++j) {
        tma_store(&p.out, ring + j * C::kOwnChunk, 64 * (chunk0 + j), own0, 0);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  }
  // no CTA leaves while another of its cluster may still multicast into its
  // shared memory or arrive on its barriers
  cluster_sync();
}

template <typename T, bool DW, int NH>
__global__ void __launch_bounds__(Sm90Bwd::kThreads, 1) fused_ce_bwd_kernel(
    const __grid_constant__ BwdParams p) {
  static_assert(std::is_same_v<T, __nv_bfloat16>, "the sm_90a backward is bf16");
  extern __shared__ __align__(128) unsigned char smem[];
  bwd_tile_sm90<DW, NH>(smem, p);
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

// How the bf16 backward runs at model width e: e's chunks dealt into slices of
// at most kSliceChunks, NH (a warpgroup's output chunks at most), and the
// grid (own tiles rounded up to whole clusters, slices)
struct BwdPlan {
  int nk, slices, nh;
  dim3 grid;
};

BwdPlan plan_bwd(int e, int n_own) {
  BwdPlan pl{};
  pl.nk = e / 64;
  pl.slices = (pl.nk + kSliceChunks - 1) / kSliceChunks;
  const int widest = (pl.nk + pl.slices - 1) / pl.slices;
  pl.nh = (widest + 1) / 2;
  const int tiles = (n_own + Sm90Bwd::BM - 1) / Sm90Bwd::BM;
  pl.grid = dim3((tiles + kCluster - 1) / kCluster * kCluster, pl.slices);
  return pl;
}

// the launch configuration of the bf16 backward: a cluster of kCluster CTAs
// along the own axis
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(const BwdPlan& pl, cudaStream_t stream) {
    cfg.gridDim = pl.grid;
    cfg.blockDim = dim3(Sm90Bwd::kThreads);
    cfg.dynamicSmemBytes = Sm90Bwd::kSmem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// the bf16 kernel for a plan, its shared memory limit raised
using Sm90Kernel = void (*)(BwdParams);

template <bool DW>
Sm90Kernel sm90_kernel_of(int nh) {
  switch (nh) {
    case 1: return fused_ce_bwd_kernel<__nv_bfloat16, DW, 1>;
    case 2: return fused_ce_bwd_kernel<__nv_bfloat16, DW, 2>;
    case 3: return fused_ce_bwd_kernel<__nv_bfloat16, DW, 3>;
    default: return fused_ce_bwd_kernel<__nv_bfloat16, DW, 4>;
  }
}

cudaError_t sm90_kernel(bool dw, const BwdPlan& pl, Sm90Kernel* kernel) {
  static_assert((kSliceChunks + 1) / 2 == 4, "sm90_kernel_of covers NH 1 to 4");
  *kernel = dw ? sm90_kernel_of<true>(pl.nh) : sm90_kernel_of<false>(pl.nh);
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Sm90Bwd::kSmem));
}

template <bool DW>
int launch_bwd_sm90(const Args& a) {
  const int n_own = DW ? a.v : a.n, n_oth = DW ? a.n : a.v;
  const void* own = DW ? a.w : a.h;
  const void* oth = DW ? a.h : a.w;
  const BwdPlan pl = plan_bwd(a.e, n_own);
  BwdParams p{};
  CUresult r = bf16_map(&p.own, own, a.e, n_own, 1, Sm90Bwd::BM);
  if (r == CUDA_SUCCESS) r = bf16_map(&p.oth, oth, a.e, n_oth, 1, Sm90Bwd::BN / kCluster);
  if (r == CUDA_SUCCESS) r = bf16_map(&p.out, a.out, a.e, n_own, 1, Sm90Bwd::BM);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  p.labels = a.labels;
  p.lse = a.lse_in;
  p.glse = a.glse;
  p.gll = a.gll;
  p.n = a.n;
  p.v = a.v;
  p.nk = pl.nk;
  p.slices = pl.slices;
  Sm90Kernel kernel = nullptr;
  cudaError_t err = sm90_kernel(DW, pl, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch launch(pl, a.stream);
  err = cudaLaunchKernelEx(&launch.cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return kind == Kind::kDh ? launch_bwd_sm90<false>(a) : launch_bwd_sm90<true>(a);
  } else {
    return kind == Kind::kDh ? launch_bwd<T, false>(a) : launch_bwd<T, true>(a);
  }
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

// The bf16 dH (dw 0) or dW (dw 1) kernel's launch at model width e, into
// out[6]: how many of its clusters the device runs at once
// (cudaOccupancyMaxActiveClusters), CTAs a cluster, ring stages, dynamic
// shared memory bytes, slices of e, and output chunks a warpgroup holds.
// Returns the CUDA error code.
extern "C" int fused_ce_bwd_plan(int device, int dw, int e, int* out) {
  if (e <= 0 || e % kBK) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdPlan pl = plan_bwd(e, Sm90Bwd::BM * kCluster);
  Sm90Kernel kernel = nullptr;
  err = sm90_kernel(dw != 0, pl, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch launch(pl, nullptr);
  err = cudaOccupancyMaxActiveClusters(&out[0], kernel, &launch.cfg);
  out[1] = kCluster;
  out[2] = kStages;
  out[3] = static_cast<int>(Sm90Bwd::kSmem);
  out[4] = pl.slices;
  out[5] = pl.nh;
  return static_cast<int>(err);
}

extern "C" const char* fused_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

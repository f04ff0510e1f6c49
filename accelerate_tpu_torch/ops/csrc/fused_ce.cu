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
// running state lives in VMEM scratch across grid steps. Here a CTA owns a
// tile of "own" rows (h rows for forward and dH, w rows for dW) and walks
// the tiles of the "other" matrix itself; only the bf16 forward splits that
// walk, over the CTAs of a thread-block cluster that merge their states in
// distributed shared memory. The reduction depth of the logits and the
// width of dH and dW are both the model width e (768 for GPT-2 small), not
// a head dim.
//
// The bf16 forward (fwd_tile_sm90, fused_ce_fwd_kernel<bf16, BN>):
//   - a CTA owns 128 h rows and one split of the vocab: the grid is (row
//     tiles, splits), and the splits of a row tile form one cluster (at
//     most 16 CTAs, past 8 the non-portable size). The Python wrapper
//     (`fwd_plan`) picks the split count that takes the fewest vocab tiles
//     a CTA times waves of clusters the card holds at once (N 8192: 2; N
//     1000: 8), 1 when the row tiles alone fill the card;
//   - the CTAs of a cluster walk the same number of vocab tiles of 128 w
//     rows in lockstep (tiles past V are zero-filled by TMA and masked) and
//     share each h chunk by TMA multicast: each loads 128 / splits h rows
//     for all, and its own w rows. A stage is refilled once the consumers
//     of every CTA of the cluster have released it (remote mbarrier
//     arrivals);
//   - a producer warpgroup (setmaxnreg 40) runs a kFwdStages-deep TMA ring;
//     a stage is one 64-column chunk of e of the CTA's h rows and of the
//     vocab tile's w rows (32 KB). h streams rather than staying resident
//     ([128, 4096] bf16 is 1 MB at Mistral's width);
//   - two consumer warpgroups (setmaxnreg 232) take 64 h rows each and
//     compute S = h . w^T for the tile by wgmma (m64n128k16, both operands
//     K-major in the 128-byte swizzle) into 64 fp32 registers a thread,
//     each span of 4 chunks (256 columns of e) in its own accumulator
//     chain and the spans added in fp32, as the backward does. S never
//     leaves the registers: the online logsumexp runs there (the row max
//     and sum over the 4 threads of a quad by two shuffles, one ex2 an
//     element with log2e folded into one fmaf, one rescale a row), and the
//     thread whose column is the row's label keeps that logit. A tile's
//     reduction runs while the next tile's first chunk is on the tensor
//     cores;
//   - each CTA leaves its split's (m, l, ll) for its 128 rows in shared
//     memory; after a cluster barrier each CTA of a row tile merges a
//     1 / splits slice of the rows over the splits in split order through
//     distributed shared memory and writes lse and ll; a second cluster
//     barrier comes before any CTA exits. Equal bits on every run, no
//     atomics, no workspace, one launch.
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
// The fp32 kernels keep the first design: the logits tile is a k-loop over
// e in 64-wide chunks, double-buffered with cp.async, of scalar FMAs (TF32
// would break the fp32 tolerance); the fp32 backward keeps its accumulator
// [32 own rows, <= 1024 columns of e] in shared memory.
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
// ring's latency, which its depth only partly hides. What holds the bf16
// forward from its bound: every CTA streams both operands from L2 (h once a
// vocab tile, w once a row tile), so by count L2 carries about
// 64 x 77 MB of w and half as much h at GPT-2 small; the reductions (about
// 400 instructions a thread a tile), only partly under the next tile's
// products; the span sums' drain (one wait for all products every 4
// chunks). PERF.md (section 6, PR 12) gives the measured share of each.
//
// Each C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a dtype or shape it does not take; the Python
// wrapper (accelerate_tpu_torch/ops/fused_ce.py) raises if the code is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"  // mbarriers, TMA (multicast too), wgmma, clusters, tensor maps

namespace {

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

// The fp32 kernels' tiles: BO own rows per CTA, BW other rows per step.
template <typename T, bool BWD>
struct Tiles {
  static constexpr int BO = BWD ? 32 : 64;
  static constexpr int BW = 64;
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
    cp_async<16>(dst + r * LD + c, src + (size_t)(ok ? row0 + r : 0) * e + k0 + c, ok);
  }
}

// Accumulator of a [BO][BW] logits tile across the e chunks, for the fp32
// kernels: each thread owns a (BO/16) x (BW/16) block (columns strided by
// 16) and sums scalar FMAs (TF32 would break the fp32 tolerance).
template <typename T, int BO, int BW, int LDK>
struct TileAcc;

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

// ------------------------------------------------- the bf16 forward on sm_90a

constexpr int kFwdStages = 4;   // the forward's TMA ring
constexpr int kMaxCluster = 16;  // CTAs of a cluster (past 8: the non-portable size)

// The bf16 forward's tiles: a CTA owns BM h rows (64 for each of two
// consumer warpgroups) and walks its split's vocab tiles of BN w rows; a
// ring stage holds one 64-column chunk of e of both.
template <int BN>
struct Sm90Fwd {
  static constexpr int BM = 128;
  static constexpr int kThreads = 3 * 128;
  static constexpr int kHChunk = BM * 128;  // bytes of [128 rows][64 columns] in bf16
  static constexpr int kWChunk = BN * 128;
  static constexpr int kStage = kHChunk + kWChunk;
  // 1024 bytes of slack to align the ring to the swizzle's 8 x 128-byte
  // period; the ring; the split's state (m, l, ll) of the BM rows; the
  // mbarriers: full and empty per stage
  static constexpr size_t kSmem = 1024 + kFwdStages * kStage + 3 * BM * 4 + 8 * 2 * kFwdStages;
};

constexpr int kFwdBN = 128;  // the vocab tile: S is [64, 128] a warpgroup, 64 fp32 a thread
static_assert(Sm90Fwd<kFwdBN>::kSmem <= kMaxSmem, "bf16 forward exceeds shared memory");

// The bf16 forward's launch: TMA maps over h [n, e] in boxes of BM / splits
// rows (a CTA's multicast share of its row tile) and w [v, e] in boxes of BN
// rows, both of 64 columns; e's 64-column chunks; the splits of the vocab
// (the cluster) and the vocab tiles of one split.
struct FwdParams {
  CUtensorMap h, w;
  const int* labels;
  float* lse;
  float* ll;
  int n, v, nk, splits, tiles_per_split;
};

// lse and ll of the rows of h against w, as fused_ce_fwd_kernel<float>
// computes them. CTA (blockIdx.x, blockIdx.y) owns h rows BM blockIdx.x +
// [0, BM) and split blockIdx.y of the vocab: vocab tiles
// [y tiles_per_split, (y + 1) tiles_per_split), past V zero-filled by TMA
// and masked. The splits of a row tile are one cluster and share each h
// chunk (each loads BM / splits of its rows for all by multicast); each
// loads its own w chunks. All CTAs of a cluster walk the same
// number of tiles in lockstep; a stage is refilled once the consumers of
// every CTA of the cluster have released it. A consumer warpgroup computes
// S = h . w^T for its 64 rows of a tile into registers (wgmma, both operands
// K-major, spans of kSpanChunks chunks summed in fp32 as in bwd_tile_sm90)
// and folds it into its rows' online (m, l) and label logit there. Each CTA
// then leaves its split's state in shared memory, and after a cluster
// barrier the splits of a row tile merge in split order through distributed
// shared memory, each CTA writing a 1 / splits slice of the rows.
template <int BN>
__device__ __forceinline__ void fwd_tile_sm90(unsigned char* smem_raw, const FwdParams& p) {
  using C = Sm90Fwd<BN>;
  constexpr int S = kFwdStages, BM = C::BM;
  constexpr float kLog2e = 1.4426950408889634f;
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* state = reinterpret_cast<float*>(ring + S * C::kStage);  // [3][BM]: m, l, ll
  uint64_t* full = reinterpret_cast<uint64_t*>(state + 3 * BM);
  uint64_t* empty = full + S;

  const int splits = p.splits, nk = p.nk, nt = p.tiles_per_split;
  const int cy = blockIdx.y;  // the split: this CTA's rank in the cluster
  const int row0 = blockIdx.x * BM;
  const int tile0 = cy * nt;  // the split's first vocab tile

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 8 * splits);  // every consumer warp of every CTA of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before a multicast or remote arrival

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: hands its registers to the consumers; thread 0 runs the
    // ring: per vocab tile, e's chunks in order, each stage an h chunk (this
    // CTA's share multicast to every split) and a w chunk
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      const uint16_t every = static_cast<uint16_t>((1u << splits) - 1);
      const int h_off = cy * (BM / splits);
      int fill = 0;
      for (int t = 0; t < nt; ++t) {
        const int v0 = (tile0 + t) * BN;
        for (int kc = 0; kc < nk; ++kc, ++fill) {
          const int st = fill % S;
          unsigned char* dst = ring + st * C::kStage;
          if (fill >= S) mbar_wait(empty + st, (fill / S - 1) & 1);
          mbar_expect_tx(full + st, C::kStage);
          if (splits == 1) {
            tma_load(dst, &p.h, full + st, 64 * kc, row0, 0);
          } else {
            tma_load_multicast(dst + h_off * 128, &p.h, full + st, 64 * kc, row0 + h_off, 0, every);
          }
          tma_load(dst + C::kHChunk, &p.w, full + st, 64 * kc, v0, 0);
        }
      }
    }
    cluster_sync();  // the states are written
    cluster_sync();  // the merge has read them
  } else {
    // consumers: warpgroup wg owns rows 64 wg + [0, 64) of the tile; this
    // thread holds rows rl and rl + 8 of S, columns 8 j + col0 + {0, 1}
    // (the wgmma accumulator layout), and those rows' running m (the same
    // in the 4 threads of a quad), its part of l, and the label logit if
    // the label's column is one of its own
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const int rl = 64 * wg + 16 * warp + lane / 4;
    int lab[2];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, ll[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + rl + 8 * r;
      const int x = row < p.n ? p.labels[row] : -1;
      lab[r] = x >= 0 && x < p.v ? x : -1;  // outside [0, V): no column, ll 0
    }
    float s[BN / 2], sp[BN / 2];
    // a stage's release: each warp arrives once on the stage's empty barrier
    // of every CTA of the cluster
    auto release = [&](int f) {
      __syncwarp();
      if (lane < splits) mbar_arrive_cluster(empty + f % S, lane);
    };
    // fold tile v0's S (in s) into the rows' (m, l) and label logit: columns
    // >= V masked to NEG_INF before the max and given p = 0; one ex2 an
    // element with log2e folded into one fmaf, one rescale a row
    auto reduce = [&](int v0) {
      const bool ragged = v0 + BN > p.v;
      if (ragged) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          if (v0 + 8 * (i / 4) + col0 + i % 2 >= p.v) s[i] = kNegInf;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (static_cast<unsigned>(lab[r] - v0) < static_cast<unsigned>(BN)) {  // rare
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            if ((i / 2) % 2 == r && v0 + 8 * (i / 4) + col0 + i % 2 == lab[r]) ll[r] = s[i];
          }
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        l[r] *= fast_exp2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        neg[r] = -m_new * kLog2e;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i / 2) % 2;
        float e = fast_exp2(fmaf(s[i], kLog2e, neg[r]));
        if (ragged && v0 + 8 * (i / 4) + col0 + i % 2 >= p.v) e = 0.f;
        l[r] += e;
      }
    };

    // S over e's chunks, both K-major (a k16 step is 32 bytes into a
    // chunk), one chunk's products in flight while the next is issued; a
    // stage is released once its products are done. The tensor cores' fp32
    // sums lose bits over a long chain, so each span of kSpanChunks chunks
    // (256 columns of e) sums in sp, and the spans add into s in fp32. The
    // last tile's reduction runs once the next tile's first chunk is queued
    // on the tensor cores, before its first span ends and overwrites s. That
    // first chunk is peeled off the loop over the rest: with the reduction
    // inside the loop, ptxas waited for every chunk's products before the
    // next chunk's issue (5% slower at GPT-2 small, PERF.md)
    const uint32_t ring_addr = smem_addr(ring);
    int f = 0, unreleased = 0;
    // chunk kc of the tile, issued from ring fill f
    auto issue = [&](int kc) {
      const uint32_t st_addr = ring_addr + (f % S) * C::kStage;
      const uint32_t a_addr = st_addr + 64 * wg * 128;
      const uint32_t b_addr = st_addr + C::kHChunk;
      mbar_wait(full + f % S, (f / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<BN>::ss(sp, sw128_desc(a_addr + kk * 32, 16, 1024),
                      sw128_desc(b_addr + kk * 32, 16, 1024), kc % kSpanChunks > 0 || kk > 0);
      }
      wgmma_commit();
    };
    // once chunk kc's products are issued: release the last chunk's stage,
    // and at a span's end wait for kc too, release it and add the span into s
    auto retire = [&](int kc) {
      wgmma_wait<1>();
      if (unreleased < f) release(unreleased++);
      if (kc % kSpanChunks == kSpanChunks - 1 || kc == nk - 1) {
        wgmma_wait<0>();
        release(unreleased++);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] = kc < kSpanChunks ? sp[i] : s[i] + sp[i];
      }
      ++f;
    };
    for (int t = 0; t < nt; ++t) {
      issue(0);
      if (t > 0) reduce((tile0 + t - 1) * BN);
      retire(0);
      for (int kc = 1; kc < nk; ++kc) {
        issue(kc);
        retire(kc);
      }
    }
    if (nt > 0) reduce((tile0 + nt - 1) * BN);

    // the split's state: l and ll over the quad, one thread a quad writes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
      l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
      ll[r] += __shfl_xor_sync(kFullMask, ll[r], 1);
      ll[r] += __shfl_xor_sync(kFullMask, ll[r], 2);
      if (lane % 4 == 0) {
        state[rl + 8 * r] = m[r];
        state[BM + rl + 8 * r] = l[r];
        state[2 * BM + rl + 8 * r] = ll[r];
      }
    }
    cluster_sync();
    // the merge: this CTA writes rows cy BM / splits + [0, BM / splits) of
    // its row tile from the states of splits 0, 1, ... in turn (an empty
    // split has m = NEG_INF and l = 0 and adds nothing); lse = m + log(l),
    // l == 0 read as 1; rows >= n write nothing
    const int per = BM / splits;
    for (int i = threadIdx.x; i < per; i += 256) {
      const int r = cy * per + i;
      float mm = kNegInf;
      for (int y = 0; y < splits; ++y) mm = fmaxf(mm, ld_dsmem(state + r, y));
      float ls = 0.f, lls = 0.f;
      for (int y = 0; y < splits; ++y) {
        ls += ld_dsmem(state + BM + r, y) * expf(ld_dsmem(state + r, y) - mm);
        lls += ld_dsmem(state + 2 * BM + r, y);
      }
      if (row0 + r < p.n) {
        p.lse[row0 + r] = mm + logf(ls == 0.f ? 1.f : ls);
        p.ll[row0 + r] = lls;
      }
    }
    cluster_sync();  // no CTA leaves while a peer may still read its state
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(Sm90Fwd<BN>::kThreads, 1) fused_ce_fwd_kernel(
    const __grid_constant__ FwdParams p) {
  static_assert(std::is_same_v<T, __nv_bfloat16>, "the sm_90a forward is bf16");
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_tile_sm90<BN>(smem, p);
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
  int splits;  // the bf16 forward's vocab splits, its cluster (ops/fused_ce.py `fwd_plan`)
};

enum class Kind { kFwd, kDh, kDw };

// Every kernel's shared-memory limit raised and clusters past 8 CTAs
// allowed, once a process: a launch sets no attribute, so each C entry is
// safe to capture in a CUDA graph
cudaError_t attributes_once() {
  static const cudaError_t err = [] {
    const cudaError_t errs[] = {
        allow_max_smem(fused_ce_fwd_kernel<float>),
        allow_max_smem(fused_ce_fwd_kernel<__nv_bfloat16, kFwdBN>),
        allow_max_smem(fused_ce_bwd_kernel<float, false>),
        allow_max_smem(fused_ce_bwd_kernel<float, true>),
        allow_max_smem(fused_ce_bwd_kernel<__nv_bfloat16, false, 1>),
        allow_max_smem(fused_ce_bwd_kernel<__nv_bfloat16, false, 2>),
        allow_max_smem(fused_ce_bwd_kernel<__nv_bfloat16, false, 3>),
        allow_max_smem(fused_ce_bwd_kernel<__nv_bfloat16, false, 4>),
        allow_max_smem(fused_ce_bwd_kernel<__nv_bfloat16, true, 1>),
        allow_max_smem(fused_ce_bwd_kernel<__nv_bfloat16, true, 2>),
        allow_max_smem(fused_ce_bwd_kernel<__nv_bfloat16, true, 3>),
        allow_max_smem(fused_ce_bwd_kernel<__nv_bfloat16, true, 4>),
    };
    for (const cudaError_t e : errs) {
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return err;
}

template <typename T>
int launch_fwd(const Args& a) {
  using C = Tiles<T, false>;
  const dim3 grid((a.n + C::BO - 1) / C::BO);
  fused_ce_fwd_kernel<T><<<grid, kThreads, Smem<T, false>::total(0), a.stream>>>(
      static_cast<const T*>(a.h), static_cast<const T*>(a.w), a.labels, a.lse_out, a.ll_out, a.n,
      a.v, a.e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DW>
int launch_bwd(const Args& a) {
  using C = Tiles<T, true>;
  const int slices = (a.e + kMaxSlice - 1) / kMaxSlice;
  const int slice = ((a.e / kBK + slices - 1) / slices) * kBK;
  const int n_own = DW ? a.v : a.n;
  const dim3 grid((n_own + C::BO - 1) / C::BO, (a.e + slice - 1) / slice);
  fused_ce_bwd_kernel<T, DW><<<grid, kThreads, Smem<T, true>::total(slice), a.stream>>>(
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

// the launch configuration of an sm_90a kernel in clusters of `cluster`
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, size_t smem, dim3 cluster, cudaStream_t stream) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster.x;
    attr[0].val.clusterDim.y = cluster.y;
    attr[0].val.clusterDim.z = cluster.z;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const BwdPlan& pl, cudaStream_t stream)
      : ClusterLaunch(pl.grid, Sm90Bwd::kThreads, Sm90Bwd::kSmem, dim3(kCluster, 1, 1), stream) {}
};

// the bf16 backward kernel for a plan
using Sm90Kernel = void (*)(BwdParams);

template <bool DW>
Sm90Kernel sm90_kernel_of(int nh) {
  static_assert((kSliceChunks + 1) / 2 == 4, "sm90_kernel_of covers NH 1 to 4");
  switch (nh) {
    case 1: return fused_ce_bwd_kernel<__nv_bfloat16, DW, 1>;
    case 2: return fused_ce_bwd_kernel<__nv_bfloat16, DW, 2>;
    case 3: return fused_ce_bwd_kernel<__nv_bfloat16, DW, 3>;
    default: return fused_ce_bwd_kernel<__nv_bfloat16, DW, 4>;
  }
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
  ClusterLaunch launch(pl, a.stream);
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, sm90_kernel_of<DW>(pl.nh), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 forward's splits, its cluster: a power of two (each CTA's h
// share, BM / splits rows, is whole swizzle periods of 8 rows), at most
// kMaxCluster
bool fwd_splits_ok(int splits) {
  return splits >= 1 && splits <= kMaxCluster && (splits & (splits - 1)) == 0;
}

ClusterLaunch fwd_launch(int n, int splits, cudaStream_t stream) {
  using C = Sm90Fwd<kFwdBN>;
  return ClusterLaunch(dim3((n + C::BM - 1) / C::BM, splits), C::kThreads, C::kSmem,
                       dim3(1, splits, 1), stream);
}

int launch_fwd_sm90(const Args& a) {
  using C = Sm90Fwd<kFwdBN>;
  if (!fwd_splits_ok(a.splits)) return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{};
  CUresult r = bf16_map(&p.h, a.h, a.e, a.n, 1, C::BM / a.splits);
  if (r == CUDA_SUCCESS) r = bf16_map(&p.w, a.w, a.e, a.v, 1, kFwdBN);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  p.labels = a.labels;
  p.lse = a.lse_out;
  p.ll = a.ll_out;
  p.n = a.n;
  p.v = a.v;
  p.nk = a.e / 64;
  p.splits = a.splits;
  p.tiles_per_split = ((a.v + kFwdBN - 1) / kFwdBN + a.splits - 1) / a.splits;
  ClusterLaunch launch = fwd_launch(a.n, a.splits, a.stream);
  const cudaError_t err =
      cudaLaunchKernelEx(&launch.cfg, fused_ce_fwd_kernel<__nv_bfloat16, kFwdBN>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 float32, 1 bfloat16
int dispatch(int device, int dtype, Kind kind, const Args& a) {
  if (a.n <= 0 || a.v <= 0 || a.e <= 0 || a.e % kBK || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = attributes_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool bf16 = dtype == 1;
  switch (kind) {
    case Kind::kFwd: return bf16 ? launch_fwd_sm90(a) : launch_fwd<float>(a);
    case Kind::kDh: return bf16 ? launch_bwd_sm90<false>(a) : launch_bwd<float, false>(a);
    default: return bf16 ? launch_bwd_sm90<true>(a) : launch_bwd<float, true>(a);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. h [n, e], w [v, e] contiguous, labels
// int32 [n], row vectors fp32 [n]. Each returns cudaGetLastError() after its
// launch; none allocates, synchronises or reads device memory on the host,
// so each may be captured in a CUDA graph. The forward's bf16 kernel splits
// the vocab `splits` ways, one cluster a row tile (the Python wrapper's plan,
// ops/fused_ce.py `fwd_plan`); the fp32 kernel ignores it.
extern "C" int fused_ce_fwd(int device, void* stream, int dtype, const void* h, const void* w,
                            const void* labels, void* lse, void* ll, int n, int v, int e,
                            int splits) {
  const Args a{h, w, static_cast<const int*>(labels), nullptr, nullptr, nullptr, nullptr,
               static_cast<float*>(lse), static_cast<float*>(ll), n, v, e,
               static_cast<cudaStream_t>(stream), splits};
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
  if (err == cudaSuccess) err = attributes_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdPlan pl = plan_bwd(e, Sm90Bwd::BM * kCluster);
  ClusterLaunch launch(pl, nullptr);
  err = cudaOccupancyMaxActiveClusters(&out[0], dw ? sm90_kernel_of<true>(pl.nh) : sm90_kernel_of<false>(pl.nh),
                                       &launch.cfg);
  out[1] = kCluster;
  out[2] = kStages;
  out[3] = static_cast<int>(Sm90Bwd::kSmem);
  out[4] = pl.slices;
  out[5] = pl.nh;
  return static_cast<int>(err);
}

// The bf16 forward's launch with the vocab split `splits` ways, into out[4]:
// how many of its clusters of `splits` CTAs the device runs at once
// (cudaOccupancyMaxActiveClusters), ring stages, dynamic shared memory
// bytes, and the rows a vocab tile holds. Returns the CUDA error code.
extern "C" int fused_ce_fwd_plan(int device, int splits, int* out) {
  if (!fwd_splits_ok(splits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = attributes_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch launch = fwd_launch(Sm90Fwd<kFwdBN>::BM, splits, nullptr);
  err = cudaOccupancyMaxActiveClusters(&out[0], fused_ce_fwd_kernel<__nv_bfloat16, kFwdBN>,
                                       &launch.cfg);
  out[1] = kFwdStages;
  out[2] = static_cast<int>(Sm90Fwd<kFwdBN>::kSmem);
  out[3] = kFwdBN;
  return static_cast<int>(err);
}

extern "C" const char* fused_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

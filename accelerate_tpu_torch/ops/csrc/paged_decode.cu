// Paged single-query decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` of
// accelerate_tpu/ops/flash_attention.py (launched by `paged_decode_attention`
// through `pl.pallas_call`). Both compute, for every slot row i and query head
// h, softmax(q . K^T * scale) V over positions 0..lengths[i]-1 of the row's
// logical sequence, where position p lives in pool block
// block_tables[i, p / block_tokens] at offset p % block_tokens.
//
// What differs from the TPU kernel: the TPU kernel stages the row's whole span
// in VMEM and runs one global-max softmax at the last grid step. Here each
// row's live blocks are split over the CTAs of one thread-block cluster, and
// the cluster sums their softmax states in distributed shared memory:
//   - grid (splits, kv heads x group chunks, rows), cluster (splits, 1, 1):
//     CTA s of a cluster owns the s-th of `splits` equal runs of the row's
//     ceil(length / block_tokens) live blocks (the run is computed on the
//     device from lengths[row], so a 1024-token row spreads over 8 SMs and a
//     one-block row takes one CTA while its peers find an empty run), and the
//     query heads of one kv head that read it (GQA: q head h reads kv head
//     h / groups), so K and V are never repeated for GQA;
//   - a CTA reads its run's table entries once, into shared memory, then
//     streams the run's K and V rows (and an int8 pool's fp32 scale planes)
//     into a ring of kStages stages of shared memory with cp.async, each row
//     addressed through the table, so kStages - 1 stages are in flight while
//     one is computed;
//   - each CTA leaves its softmax state (running max m, denominator l, fp32
//     numerator acc per query head) in shared memory; after a cluster barrier
//     each CTA of the cluster merges one slice of the output over the
//     cluster's states, read through distributed shared memory in split
//     order, and writes it; a second cluster barrier keeps every CTA's
//     shared memory alive until its peers have read it. One launch, no
//     workspace, no atomics: equal bits in every run;
//   - compute is on the CUDA cores (about 2 x groups flops a byte, far below
//     the card's balance point): head_dim 64 or 128 with 1, 2, 4 or 8 query
//     heads per kv head take a register body (lanes split a row into 16- or
//     8-byte pieces, a warp takes 4 positions of a stage, the max over them
//     is taken before the exponentials, so one exp per position and head);
//     every other head_dim and group count takes a general body that keeps
//     q, the scores and the numerator in shared memory (query heads in
//     chunks of at most kGroupChunk a CTA), with row pieces of 16, 4 or one
//     element's bytes, whichever the row and the pool's alignment allow.
//
// Bound: bandwidth. Each live K/V byte is read exactly once, and the work per
// byte is 2 * groups flops per element for QK^T plus as many for PV, below the
// card's ~20 fp32 flop/byte balance point for groups <= 8. At GPT-2-small
// shapes (16 rows, 12 kv heads, head_dim 64, bf16 pool, mean length 512) one
// call reads 16 * 512 * 12 * 64 * 2 bytes * 2 (K and V) = 25.2 MB, which takes
// 7.5 us at the H100 SXM's 3.35 TB/s HBM3 peak (NVIDIA data sheet;
// chip_smoke.py takes the peak from the SKU in the device name).
//
// Semantics kept from the TPU kernel:
//   - logits are scaled AFTER the dot (q is not pre-scaled);
//   - a table entry >= num_blocks (the engine's released-slot sentinel) is
//     clamped to num_blocks - 1;
//   - a row with length <= 0 writes zeros;
//   - an int8 pool is dequantized as (int8 -> fp32) * scale, cast to q's
//     dtype and back to fp32, exactly like the TPU kernel's staging.
//
// The C entry point allocates nothing, never synchronises and reads no device
// data on the host, so a CUDA graph can capture it; it returns
// cudaGetLastError() after the launch, and the Python wrapper
// (accelerate_tpu_torch/ops/flash_attention.py) raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;       // ring depth
constexpr int kTok = 16;         // positions a stage holds (register body)
constexpr int kMaxSplits = 8;    // CTAs a cluster: the portable cluster size
constexpr int kGroupChunk = 8;   // query heads a CTA holds (general body)
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
};

// one pool element widened to fp32: an int8 value dequantized with its fp32
// scale and rounded through the compute dtype TQ, as the TPU kernel stages it
template <typename TQ, typename TKV, bool QUANT>
__device__ __forceinline__ float widen(TKV v, float scale) {
  if constexpr (QUANT) {
    return Cvt<TQ>::to_f(Cvt<TQ>::from_f(static_cast<float>(v) * scale));
  } else {
    return Cvt<TKV>::to_f(v);
  }
}

// E pool elements (16 or 8 bytes, aligned) from shared memory, widened
template <typename TQ, typename TKV, bool QUANT, int E>
__device__ __forceinline__ void load_piece(const TKV* src, float scale, float* out) {
  TKV vals[E];
  if constexpr (E * sizeof(TKV) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    memcpy(vals, &raw, sizeof(raw));
  } else {
    static_assert(E * sizeof(TKV) == 8, "a piece is 16 or 8 bytes");
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    memcpy(vals, &raw, sizeof(raw));
  }
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = widen<TQ, TKV, QUANT>(vals[i], scale);
}

// PB bytes of a pool row from global to shared memory: cp.async for 4 and 16
// bytes, a plain load and store for one element of 1 or 2 bytes
template <int PB>
__device__ __forceinline__ void copy_piece(unsigned char* dst, const unsigned char* src) {
  if constexpr (PB >= 4) {
    cp_async<PB>(dst, src, true);
  } else if constexpr (PB == 2) {
    *reinterpret_cast<unsigned short*>(dst) = __ldg(reinterpret_cast<const unsigned short*>(src));
  } else {
    *dst = __ldg(src);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// What one launch reads, and where its pieces sit in dynamic shared memory
// (byte offsets): the CTA's table entries, the ring (a stage holds `tok`
// rows of K, then as many of V, then an int8 pool's `tok` K and `tok` V
// scales), the CTA's softmax state (m and l per query head, then the
// numerator, then room for the merge's weights), and for the general body q
// and the scores.
struct Params {
  const void* q;             // [b, kvh * groups, d]
  const void* k_pool;        // [num_blocks, bt, kvh, d]
  const void* v_pool;
  const float* k_scale;      // [num_blocks, bt, kvh] (int8 pool)
  const float* v_scale;
  const int* tables;         // [b, bps]
  const int* lengths;        // [b]
  void* out;                 // [b, kvh * groups, d]
  int num_blocks, bt, kvh, bps, d, groups;
  int tok, gcap;             // positions a stage, query heads a CTA
  int v_off, s_off, stage_bytes;
  int ring_off, state_off, q_off, sc_off, smem;
  float scale;
};

// grid (splits, kvh * ceil(groups / gcap), b), cluster (splits, 1, 1).
// D and G are the register body's head_dim and group count, 0 for the
// general body; PB is the bytes a thread copies per piece of a pool row.
template <typename TQ, typename TKV, bool QUANT, int D, int G, int PB>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const Params p) {
  constexpr bool kGeneral = D == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + p.ring_off;
  const int d = kGeneral ? p.d : D;
  const int groups = kGeneral ? p.groups : G;
  const int gcap = kGeneral ? p.gcap : G;
  const int tok = kGeneral ? p.tok : kTok;
  float* st_m = reinterpret_cast<float*>(smem + p.state_off);
  float* st_l = st_m + gcap;
  float* st_acc = st_l + gcap;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int split = static_cast<int>(cluster_ctarank());
  const int splits = static_cast<int>(cluster_nctarank());
  const int nchunks = (groups + gcap - 1) / gcap;
  const int h = blockIdx.y / nchunks;
  const int g0 = (blockIdx.y - h * nchunks) * gcap;
  const int gc = min(gcap, groups - g0);
  const int row = blockIdx.z;

  // this CTA's run: blocks [b0, b1) of the row's live blocks, positions [t0, t1)
  const int len = max(0, min(p.lengths[row], p.bps * p.bt));
  const int nblk = (len + p.bt - 1) / p.bt;
  const int per_split = (nblk + splits - 1) / splits;
  const int b0 = min(nblk, split * per_split);
  const int b1 = min(nblk, b0 + per_split);
  const int t0 = b0 * p.bt;
  const int t1 = min(len, b1 * p.bt);
  const int nst = (max(0, t1 - t0) + tok - 1) / tok;

  const int* trow = p.tables + static_cast<size_t>(row) * p.bps;
  for (int i = tid; i < b1 - b0; i += kThreads) tbl[i] = min(trow[b0 + i], p.num_blocks - 1);
  const size_t head0 = (static_cast<size_t>(row) * p.kvh + h) * groups + g0;  // first q head
  if constexpr (kGeneral) {
    float* sq = reinterpret_cast<float*>(smem + p.q_off);
    const TQ* qp = static_cast<const TQ*>(p.q) + head0 * d;
    for (int i = tid; i < gc * d; i += kThreads) {
      sq[i] = Cvt<TQ>::to_f(qp[i]);
      st_acc[i] = 0.f;
    }
    for (int g = tid; g < gc; g += kThreads) {
      st_m[g] = -INFINITY;
      st_l[g] = 0.f;
    }
  }
  __syncthreads();

  // stage s of the ring: positions [t0 + s * tok, +tok) of the run
  const unsigned char* kbase = static_cast<const unsigned char*>(p.k_pool);
  const unsigned char* vbase = static_cast<const unsigned char*>(p.v_pool);
  auto issue = [&](int s) {
    unsigned char* st = ring + (s % kStages) * p.stage_bytes;
    const int pos0 = t0 + s * tok;
    const int n = min(tok, t1 - pos0);
    const int row_bytes = d * static_cast<int>(sizeof(TKV));
    const int ppr = row_bytes / PB;
    const int total = n * ppr;
    for (int i = tid; i < 2 * total; i += kThreads) {
      const bool is_v = i >= total;
      const int j = is_v ? i - total : i;
      const int t = j / ppr;
      const int c = j - t * ppr;
      const int pos = pos0 + t;
      const size_t tr = static_cast<size_t>(tbl[pos / p.bt - b0]) * p.bt + pos % p.bt;
      const unsigned char* src = (is_v ? vbase : kbase) + (tr * p.kvh + h) * row_bytes + c * PB;
      copy_piece<PB>(st + (is_v ? p.v_off : 0) + t * row_bytes + c * PB, src);
    }
    if constexpr (QUANT) {
      float* ss = reinterpret_cast<float*>(st + p.s_off);
      for (int i = tid; i < 2 * n; i += kThreads) {
        const bool is_v = i >= n;
        const int t = is_v ? i - n : i;
        const int pos = pos0 + t;
        const size_t tr = static_cast<size_t>(tbl[pos / p.bt - b0]) * p.bt + pos % p.bt;
        cp_async<4>(ss + (is_v ? tok : 0) + t, (is_v ? p.v_scale : p.k_scale) + tr * p.kvh + h,
                    true);
      }
    }
  };
  // the ring's turn for stage s: wait for it, then refill the slot the
  // previous stage freed
  auto advance = [&](int s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < nst) issue(s + kStages - 1);
    cp_async_commit();
    return ring + (s % kStages) * p.stage_bytes;
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }

  if constexpr (kGeneral) {
    // scores, softmax and numerator through shared memory
    const float* sq = reinterpret_cast<const float*>(smem + p.q_off);
    float* sc = reinterpret_cast<float*>(smem + p.sc_off);  // [gcap][tok]
    float* corr = sc + gcap * tok;
    for (int s = 0; s < nst; ++s) {
      const unsigned char* st = advance(s);
      const TKV* ks = reinterpret_cast<const TKV*>(st);
      const TKV* vs = reinterpret_cast<const TKV*>(st + p.v_off);
      const float* ksc = reinterpret_cast<const float*>(st + p.s_off);
      const float* vsc = ksc + tok;
      const int n = min(tok, t1 - (t0 + s * tok));
      for (int pair = warp; pair < gc * n; pair += kWarps) {
        const int g = pair / n;
        const int t = pair - g * n;
        const float kscale = QUANT ? ksc[t] : 1.f;
        float dot = 0.f;
        for (int c = lane; c < d; c += 32)
          dot = fmaf(sq[g * d + c], widen<TQ, TKV, QUANT>(ks[t * d + c], kscale), dot);
        dot = warp_sum(dot);
        if (lane == 0) sc[g * tok + t] = dot * p.scale;  // after the dot, as the TPU kernel
      }
      __syncthreads();
      for (int g = warp; g < gc; g += kWarps) {
        const float x = lane < n ? sc[g * tok + lane] : -INFINITY;
        const float mo = st_m[g];
        const float mn = fmaxf(mo, warp_max(x));  // finite: the stage holds n >= 1 positions
        const float e = lane < n ? expf(x - mn) : 0.f;
        const float sum = warp_sum(e);
        if (lane < n) sc[g * tok + lane] = e;
        if (lane == 0) {
          const float c = expf(mo - mn);  // 0 while the state is empty (mo = -inf)
          corr[g] = c;
          st_l[g] = st_l[g] * c + sum;
          st_m[g] = mn;
        }
      }
      __syncthreads();
      for (int i = tid; i < gc * d; i += kThreads) {
        const int g = i / d;
        const int c = i - g * d;
        float a = st_acc[i] * corr[g];
        for (int t = 0; t < n; ++t)
          a = fmaf(sc[g * tok + t], widen<TQ, TKV, QUANT>(vs[t * d + c], QUANT ? vsc[t] : 1.f), a);
        st_acc[i] = a;
      }
    }
  } else {
    // registers: LANES lanes read one row in pieces of E elements, a warp
    // covers TPW rows at a time and takes WTOK positions of each stage
    constexpr int E = sizeof(TKV) == 4 ? 4 : 8;
    constexpr int LANES = D / E;
    static_assert(LANES >= 1 && LANES <= 32 && 32 % LANES == 0, "unsupported head_dim");
    constexpr int TPW = 32 / LANES;
    constexpr int WTOK = kTok / kWarps;
    static_assert(WTOK % TPW == 0, "a warp's positions are whole passes");
    constexpr int PASSES = WTOK / TPW;
    const int sub = lane / LANES;   // which row of a pass
    const int part = lane % LANES;  // which piece of the row

    float qv[G][E];
    const TQ* qp = static_cast<const TQ*>(p.q) + head0 * D + part * E;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < E; ++i) qv[g][i] = Cvt<TQ>::to_f(qp[g * D + i]);
    // the warp shares m; l and acc are the lane group's
    float m[G], l[G], acc[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
    }

    for (int s = 0; s < nst; ++s) {
      const unsigned char* st = advance(s);
      const TKV* ks = reinterpret_cast<const TKV*>(st);
      const TKV* vs = reinterpret_cast<const TKV*>(st + p.v_off);
      const float* ksc = reinterpret_cast<const float*>(st + p.s_off);
      const float* vsc = ksc + kTok;
      const int n = min(kTok, t1 - (t0 + s * kTok));
      float sc[PASSES][G];
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        const int t = warp * WTOK + ps * TPW + sub;
        float kf[E];
        load_piece<TQ, TKV, QUANT, E>(ks + t * D + part * E, QUANT ? ksc[t] : 1.f, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < E; ++i) dot = fmaf(qv[g][i], kf[i], dot);
#pragma unroll
          for (int o = LANES / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFullMask, dot, o);
          sc[ps][g] = t < n ? dot * p.scale : -INFINITY;  // a row past the run is masked
        }
      }
      // the max over the warp's positions first, then one exp per position
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = sc[0][g];
#pragma unroll
        for (int ps = 1; ps < PASSES; ++ps) mx = fmaxf(mx, sc[ps][g]);
#pragma unroll
        for (int o = LANES; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
        const float mn = fmaxf(m[g], mx);
        const float c = mn == -INFINITY ? 1.f : expf(m[g] - mn);
        l[g] *= c;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] *= c;
        m[g] = mn;
      }
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        const int t = warp * WTOK + ps * TPW + sub;
        if (t < n) {
          float vf[E];
          load_piece<TQ, TKV, QUANT, E>(vs + t * D + part * E, QUANT ? vsc[t] : 1.f, vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float e = expf(sc[ps][g] - m[g]);
            l[g] += e;
#pragma unroll
            for (int i = 0; i < E; ++i) acc[g][i] = fmaf(e, vf[i], acc[g][i]);
          }
        }
      }
    }

    // the warp's row streams share m: add them (lanes LANES apart hold the
    // same piece)
#pragma unroll
    for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        l[g] += __shfl_xor_sync(kFullMask, l[g], o);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] += __shfl_xor_sync(kFullMask, acc[g][i], o);
      }
    }
    // the warps' states through the ring's memory, merged into the CTA's
    cp_async_wait<0>();
    __syncthreads();
    float* wm = reinterpret_cast<float*>(ring);  // [kWarps][G]
    float* wl = wm + kWarps * G;                 // [kWarps][G]
    float* wacc = wl + kWarps * G;               // [kWarps][G][D]
    if (sub == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int i = 0; i < E; ++i) wacc[(warp * G + g) * D + part * E + i] = acc[g][i];
        if (part == 0) {
          wm[warp * G + g] = m[g];
          wl[warp * G + g] = l[g];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
      float den = 0.f, num = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float mw = wm[w * G + g];
          if (mw == -INFINITY) continue;
          const float f = expf(mw - mx);
          den += wl[w * G + g] * f;
          num += wacc[(w * G + g) * D + i - g * D] * f;
        }
      }
      st_acc[i] = num;
      if (i == g * D) {
        st_m[g] = mx;
        st_l[g] = den;
      }
    }
  }

  // every CTA's state is in its shared memory: each CTA merges one slice of
  // the cluster's outputs over the states of splits 0, 1, ... in turn. First
  // each split's weight exp(m_split - m) for each query head and the merged
  // denominator, then the numerators; every split's load is in flight
  // before the sum
  cluster_sync();
  float* weight = st_acc + gcap * d;  // [kMaxSplits][gcap], then the denominators [gcap]
  for (int g = tid; g < gc; g += kThreads) {
    float mr[kMaxSplits], lr[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      mr[r] = r < splits ? ld_dsmem(st_m + g, r) : -INFINITY;
      lr[r] = r < splits ? ld_dsmem(st_l + g, r) : 0.f;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) mx = fmaxf(mx, mr[r]);
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const float f = mr[r] == -INFINITY ? 0.f : expf(mr[r] - mx);  // 0 for an empty run
      weight[r * gcap + g] = f;
      den += lr[r] * f;
    }
    weight[kMaxSplits * gcap + g] = den;  // 0 when every run is empty, else >= 1
  }
  __syncthreads();
  const int nout = gc * d;
  const int slice = (nout + splits - 1) / splits;
  const int lo = split * slice;
  const int hi = min(nout, lo + slice);
  TQ* out = static_cast<TQ*>(p.out) + head0 * d;
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int g = i / d;
    float a[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) a[r] = r < splits ? ld_dsmem(st_acc + i, r) : 0.f;
    float num = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) num += a[r] * weight[r * gcap + g];
    const float den = weight[kMaxSplits * gcap + g];
    out[i] = Cvt<TQ>::from_f(den > 0.f ? num / den : 0.f);  // length <= 0: write 0
  }
  cluster_sync();  // no CTA leaves while a peer may still read its state
}

size_t round16(size_t x) { return (x + 15) / 16 * 16; }

// Lay out dynamic shared memory for `splits` CTAs a row. The general body
// halves its positions a stage, then its query heads a CTA, until the plan
// fits; false if nothing fits.
template <typename TKV, bool QUANT>
bool plan(Params& p, bool general, int splits) {
  const size_t tbl = round16(static_cast<size_t>((p.bps + splits - 1) / splits) * sizeof(int));
  for (;;) {
    const size_t rows = round16(static_cast<size_t>(p.tok) * p.d * sizeof(TKV));
    const size_t stage = 2 * rows + (QUANT ? round16(2 * p.tok * sizeof(float)) : 0);
    size_t ring = kStages * stage;
    if (!general)  // the warps' states reuse the ring at the end
      ring = std::max(ring, round16(static_cast<size_t>(kWarps) * p.gcap * (p.d + 2) * sizeof(float)));
    // m, l, the numerator, then the merge's weights and denominators
    const size_t state =
        round16(static_cast<size_t>(p.gcap) * (p.d + 2 + kMaxSplits + 1) * sizeof(float));
    const size_t q = general ? round16(static_cast<size_t>(p.gcap) * p.d * sizeof(float)) : 0;
    const size_t sc = general ? round16(static_cast<size_t>(p.gcap) * (p.tok + 1) * sizeof(float)) : 0;
    const size_t total = tbl + ring + state + q + sc;
    if (total <= kMaxSmem) {
      p.v_off = static_cast<int>(rows);
      p.s_off = static_cast<int>(2 * rows);
      p.stage_bytes = static_cast<int>(stage);
      p.ring_off = static_cast<int>(tbl);
      p.state_off = static_cast<int>(tbl + ring);
      p.q_off = static_cast<int>(tbl + ring + state);
      p.sc_off = static_cast<int>(tbl + ring + state + q);
      p.smem = static_cast<int>(total);
      return true;
    }
    if (!general) return false;
    if (p.tok > 1) {
      p.tok = (p.tok + 1) / 2;
    } else if (p.gcap > 1) {
      p.gcap = (p.gcap + 1) / 2;
    } else {
      return false;
    }
  }
}

template <typename TQ, typename TKV, bool QUANT, int D, int G, int PB>
int launch(Params p, int batch, cudaStream_t stream) {
  constexpr bool general = D == 0;
  const int splits = std::min(kMaxSplits, p.bps);
  p.tok = kTok;
  p.gcap = general ? std::min(p.groups, kGroupChunk) : G;
  if (!plan<TKV, QUANT>(p, general, splits)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_decode_kernel<TQ, TKV, QUANT, D, G, PB>;
  static const cudaError_t prepared = allow_max_smem(kernel);
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  const int chunks = (p.groups + p.gcap - 1) / p.gcap;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(splits, p.kvh * chunks, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT, int D>
int launch_groups(const Params& p, int batch, cudaStream_t stream) {
  switch (p.groups) {
    case 1: return launch<TQ, TKV, QUANT, D, 1, 16>(p, batch, stream);
    case 2: return launch<TQ, TKV, QUANT, D, 2, 16>(p, batch, stream);
    case 4: return launch<TQ, TKV, QUANT, D, 4, 16>(p, batch, stream);
    default: return launch<TQ, TKV, QUANT, D, 8, 16>(p, batch, stream);
  }
}

// the register body where it is built (head_dim 64 or 128, groups 1, 2, 4 or
// 8, 16-byte aligned pools), else the general body with the widest row piece
// that the row's bytes and both pools' alignment allow
template <typename TQ, typename TKV, bool QUANT>
int dispatch(const Params& p, int batch, cudaStream_t stream) {
  const size_t row_bytes = static_cast<size_t>(p.d) * sizeof(TKV);
  auto fits = [&](size_t pb) {
    return row_bytes % pb == 0 && reinterpret_cast<uintptr_t>(p.k_pool) % pb == 0 &&
           reinterpret_cast<uintptr_t>(p.v_pool) % pb == 0;
  };
  const bool reg_groups = p.groups == 1 || p.groups == 2 || p.groups == 4 || p.groups == 8;
  if (reg_groups && fits(16)) {
    if (p.d == 64) return launch_groups<TQ, TKV, QUANT, 64>(p, batch, stream);
    if (p.d == 128) return launch_groups<TQ, TKV, QUANT, 128>(p, batch, stream);
  }
  if (fits(16)) return launch<TQ, TKV, QUANT, 0, 0, 16>(p, batch, stream);
  if (fits(4)) return launch<TQ, TKV, QUANT, 0, 0, 4>(p, batch, stream);
  constexpr int kElem = sizeof(TKV) < 4 ? static_cast<int>(sizeof(TKV)) : 4;
  return launch<TQ, TKV, QUANT, 0, 0, kElem>(p, batch, stream);
}

template <typename TQ>
int dispatch_pool(int kv_dtype, int q_dtype, const Params& p, int batch, cudaStream_t stream) {
  if (kv_dtype == 3) return dispatch<TQ, int8_t, true>(p, batch, stream);
  if (kv_dtype == q_dtype) return dispatch<TQ, TQ, false>(p, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 int8 (pool only, with
// fp32 scale planes). Any head_dim and any groups = n_heads / kv_heads.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// combination the kernel does not take (a dtype pair, a head_dim whose rows
// do not fit shared memory).
extern "C" int paged_decode_attention(
    int device, void* stream, int q_dtype, int kv_dtype, int head_dim, int groups,
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* out,
    int batch, int kv_heads, int num_blocks, int block_tokens, int blocks_per_slot,
    float scale) {
  if (head_dim < 1 || groups < 1 || batch < 1 || batch > 65535 || kv_heads < 1 ||
      num_blocks < 1 || block_tokens < 1 || blocks_per_slot < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p{};
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.num_blocks = num_blocks;
  p.bt = block_tokens;
  p.kvh = kv_heads;
  p.bps = blocks_per_slot;
  p.d = head_dim;
  p.groups = groups;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return dispatch_pool<float>(kv_dtype, q_dtype, p, batch, s);
    case 1: return dispatch_pool<__nv_bfloat16>(kv_dtype, q_dtype, p, batch, s);
    case 2: return dispatch_pool<__half>(kv_dtype, q_dtype, p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

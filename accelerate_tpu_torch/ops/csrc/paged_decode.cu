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
// in VMEM and runs one global-max softmax at the last grid step. Here one CTA
// owns one (slot row, kv head) pair and the GROUPS query heads that read that
// kv head (GQA: q head h reads kv head h / GROUPS). Its warps walk only the
// first ceil(length / block_tokens) table blocks with a running max and
// denominator in fp32 (an online softmax), then combine their partial states
// in shared memory. Nothing is staged in device memory and K/V are never
// repeated for GQA.
//
// Bound: bandwidth. Each live K/V byte is read exactly once, and the work per
// byte is 2 * GROUPS flops per element for QK^T plus as many for PV, far below
// the card's ~295 flop/byte balance point. At GPT-2-small shapes (16 rows,
// 12 kv heads, head_dim 64, bf16 pool, mean length 512) one call reads
// 16 * 512 * 12 * 64 * 2 bytes * 2 (K and V) = 25.2 MB, which takes 7.5 us at
// the H100 SXM's 3.35 TB/s HBM3 peak (NVIDIA data sheet; chip_smoke.py takes
// the peak from the SKU in the device name). Each lane loads 16 bytes of a
// token's head row, so a token's row is read by D * sizeof(T) / 16 adjacent
// lanes in one coalesced transaction, at the pool's kv_heads * D stride.
//
// Semantics kept from the TPU kernel:
//   - logits are scaled AFTER the dot (q is not pre-scaled);
//   - a table entry >= num_blocks (the engine's released-slot sentinel) is
//     clamped to num_blocks - 1;
//   - a row with length <= 0 writes zeros;
//   - an int8 pool is dequantized as (int8 -> fp32) * scale, cast to q's
//     dtype and back to fp32, exactly like the TPU kernel's staging.
//
// The C entry point returns cudaGetLastError() after the launch; the Python
// wrapper (accelerate_tpu_torch/ops/flash_attention.py) raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
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

// One 16-byte load of VEC pool elements, widened to fp32. For an int8 pool
// each value is dequantized with its fp32 scale and rounded through the
// compute dtype TQ, as the TPU kernel stages it.
template <typename TQ, typename TKV, bool QUANT>
__device__ __forceinline__ void load_row(const TKV* __restrict__ p, float scale,
                                         float* out) {
  constexpr int VEC = 16 / sizeof(TKV);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  TKV vals[VEC];
  memcpy(vals, &raw, sizeof(raw));
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (QUANT) {
      out[i] = Cvt<TQ>::to_f(Cvt<TQ>::from_f(static_cast<float>(vals[i]) * scale));
    } else {
      out[i] = Cvt<TKV>::to_f(vals[i]);
    }
  }
}

// Fold the softmax state (m2, l2, acc2) into (m, l, acc). An empty state has
// m = -inf and l = acc = 0.
template <int VEC>
__device__ __forceinline__ void merge_state(float& m, float& l, float* acc,
                                            float m2, float l2, const float* acc2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  const float a = expf(m - mn);
  const float b = expf(m2 - mn);
  l = l * a + l2 * b;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = acc[i] * a + acc2[i] * b;
  m = mn;
}

template <typename TQ, typename TKV, int D, int G, bool QUANT>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q,             // [b, kvh * G, D]
                    const TKV* __restrict__ k_pool,       // [num_blocks, bt, kvh, D]
                    const TKV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,    // [num_blocks, bt, kvh] (QUANT)
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,       // [b, bps]
                    const int* __restrict__ lengths,      // [b]
                    TQ* __restrict__ out,                 // [b, kvh * G, D]
                    int num_blocks, int block_tokens, int kvh, int bps, float scale) {
  constexpr int VEC = 16 / sizeof(TKV);  // pool elements per lane per load
  constexpr int LANES = D / VEC;         // lanes that share one token's head row
  static_assert(LANES >= 1 && LANES <= 32 && 32 % LANES == 0, "unsupported head_dim");
  constexpr int TPW = 32 / LANES;        // tokens a warp covers per step

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int h = blockIdx.x;    // kv head
  const int row = blockIdx.y;  // slot row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LANES;   // which token of the warp step
  const int part = lane % LANES;  // which VEC slice of the head row
  const int length = min(lengths[row], bps * block_tokens);

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const TQ* qp = q + ((size_t)row * kvh * G + (size_t)h * G + g) * D + part * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) qv[g][i] = Cvt<TQ>::to_f(qp[i]);
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const int* trow = tables + (size_t)row * bps;
  const size_t tok_stride = (size_t)kvh * D;
  // warp-uniform loop: every lane takes part in the shuffles, lanes whose
  // token lies past the frontier load nothing and leave their state alone
  for (int p0 = warp * TPW; p0 < length; p0 += kWarps * TPW) {
    const int p = p0 + sub;
    const bool valid = p < length;
    float kf[VEC], vf[VEC];
    if (valid) {
      const int blk = min(trow[p / block_tokens], num_blocks - 1);
      const size_t tok = (size_t)blk * block_tokens + p % block_tokens;
      const size_t off = tok * tok_stride + (size_t)h * D + part * VEC;
      float ks = 1.f, vs = 1.f;
      if constexpr (QUANT) {
        ks = k_scale[tok * kvh + h];
        vs = v_scale[tok * kvh + h];
      }
      load_row<TQ, TKV, QUANT>(k_pool + off, ks, kf);
      load_row<TQ, TKV, QUANT>(v_pool + off, vs, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(qv[g][i], kf[i], s);
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
      s *= scale;  // after the dot, as the TPU kernel does
      if (valid) {
        const float mn = fmaxf(m[g], s);
        const float c = expf(m[g] - mn);
        const float e = expf(s - mn);
        l[g] = l[g] * c + e;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(e, vf[i], acc[g][i] * c);
        m[g] = mn;
      }
    }
  }

  // merge the TPW token streams of the warp: lanes holding the same slice of
  // the head row sit LANES apart
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m2 = __shfl_xor_sync(kFullMask, m[g], o);
      const float l2 = __shfl_xor_sync(kFullMask, l[g], o);
      float acc2[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc2[i] = __shfl_xor_sync(kFullMask, acc[g][i], o);
      merge_state<VEC>(m[g], l[g], acc[g], m2, l2, acc2);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][part * VEC + i] = acc[g][i];
      if (part == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and write the GROUPS output rows of this kv head
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float o = 0.f;
    if (mx != -INFINITY) {  // length <= 0 leaves every state empty: write 0
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(sm_m[w][g] - mx);
        den += sm_l[w][g] * f;
        num += sm_acc[w][g][d] * f;
      }
      o = num / den;
    }
    out[((size_t)row * kvh * G + (size_t)h * G + g) * D + d] = Cvt<TQ>::from_f(o);
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  void* out;
  int batch, kv_heads, num_blocks, block_tokens, blocks_per_slot;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int G, bool QUANT>
int launch(const Args& a) {
  const dim3 grid(a.kv_heads, a.batch);
  paged_decode_kernel<TQ, TKV, D, G, QUANT><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.k_scale, a.v_scale, a.tables, a.lengths,
      static_cast<TQ*>(a.out), a.num_blocks, a.block_tokens, a.kv_heads,
      a.blocks_per_slot, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D, bool QUANT>
int dispatch_groups(int groups, const Args& a) {
  switch (groups) {
    case 1: return launch<TQ, TKV, D, 1, QUANT>(a);
    case 2: return launch<TQ, TKV, D, 2, QUANT>(a);
    case 4: return launch<TQ, TKV, D, 4, QUANT>(a);
    case 8: return launch<TQ, TKV, D, 8, QUANT>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ, typename TKV, bool QUANT>
int dispatch_dims(int head_dim, int groups, const Args& a) {
  switch (head_dim) {
    case 64: return dispatch_groups<TQ, TKV, 64, QUANT>(groups, a);
    case 128: return dispatch_groups<TQ, TKV, 128, QUANT>(groups, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int dispatch_pool(int kv_dtype, int q_dtype, int head_dim, int groups, const Args& a) {
  if (kv_dtype == 3) return dispatch_dims<TQ, int8_t, true>(head_dim, groups, a);
  if (kv_dtype == q_dtype) return dispatch_dims<TQ, TQ, false>(head_dim, groups, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 int8 (pool only, with
// fp32 scale planes). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a combination the kernel is not built for.
extern "C" int paged_decode_attention(
    int device, void* stream, int q_dtype, int kv_dtype, int head_dim, int groups,
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* out,
    int batch, int kv_heads, int num_blocks, int block_tokens, int blocks_per_slot,
    float scale) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(tables), static_cast<const int*>(lengths), out,
               batch, kv_heads, num_blocks, block_tokens, blocks_per_slot, scale,
               static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case 0: return dispatch_pool<float>(kv_dtype, q_dtype, head_dim, groups, a);
    case 1: return dispatch_pool<__nv_bfloat16>(kv_dtype, q_dtype, head_dim, groups, a);
    case 2: return dispatch_pool<__half>(kv_dtype, q_dtype, head_dim, groups, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

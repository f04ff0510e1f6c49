// NF4 dequant-matmul for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of accelerate_tpu/ops/nf4_matmul.py:43
// (launched by `nf4_matmul` through `pl.pallas_call`). Both compute
// out[M, N] = x[M, K] @ W[K, N] in fp32, cast to x's dtype, where W is an NF4
// weight in plane layout: byte (k, j) of the [K, P] uint8 plane (P = N / 2)
// holds the code of W[k, j] in its high nibble and of W[k, j + P] in its low
// nibble, and W[k, j] = NF4[code] * scales[plane][k][j / 64] in fp32.
//
// What differs from the TPU kernel: the TPU kernel walks a sequential K grid
// axis, accumulating into its output block, and writes a [2, M, P] fp32
// result that the wrapper concatenates and casts. Here the K loop runs inside
// the CTA and the CTA writes its [M, N] outputs in x's dtype directly; when
// the output tiles alone cannot fill the card, K is split over CTAs and a
// second pass sums the splits' fp32 partials in a fixed order (no atomics, so
// the sum is the same in every run).
//
// Bound: at decode M (1..16) the product is bound by bytes: the 4-bit payload
// plus one fp32 scale per 64 weights, K * N * (0.5 + 4 / 64) bytes, 9.4 MB at
// a 4096 x 4096 weight, 2.8 us at the H100 SXM's 3.35 TB/s (data sheet). Past
// about 10 rows the fp32 multiply-adds on the CUDA cores (67 TFLOP/s) bound it
// instead: the dequantized weight stays fp32, as in the TPU kernel.
// What the design does about it:
//   - a thread owns 4 adjacent byte columns (one 4-byte load a row) and so 8
//     outputs, columns c..c+3 and P+c..P+c+3: every byte loaded yields both
//     planes' weights, and a warp reads one 128-byte row segment, coalesced;
//   - the 4 warps of a CTA share the column tile and take every 4th row, each
//     with 8 rows' loads in flight (4 past 4 rows of x), and add their partial
//     sums through shared memory at the end, in warp order;
//   - K is split over more CTAs at small M (up to 8 a SM at one row), so
//     enough loads are in flight to keep the memory busy;
//   - the x rows of the CTA's M tile (up to 16) are staged in shared memory,
//     fp32, a K chunk at a time, and read as broadcasts; each dequantized
//     weight is reused across them from registers;
//   - the 16-entry codebook sits in shared memory, where 32 lanes looking up
//     16 entries hit 16 banks; one fp32 scale covers a lane's 4 columns;
//   - M is tiled in the grid (ROWS = the next power of two of M, at most 16),
//     so prefill's thousands of rows run on the same kernel.
//
// The C entry point returns cudaGetLastError() after the launches; the Python
// wrapper (accelerate_tpu_torch/ops/nf4_matmul.py) raises if it is not 0. The
// wrapper allocates the [splits, M, N] fp32 workspace.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = 128;  // byte columns of a CTA: 32 lanes x 4 bytes
constexpr int kMaxRows = 16;     // M rows of a CTA
constexpr int kChunk = 128;      // K rows of x staged in shared memory at a time

__constant__ float kNf4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

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

// grid (ceil(P / 128), ceil(M / ROWS), splits); block 128 threads. CTA
// (bx, by, bz) computes rows [by * ROWS, +ROWS) of x against byte columns
// [bx * 128, +128) over K rows [bz * rows_per_split, +rows_per_split). With
// one split it writes out[M, N] in T; with more it writes its fp32 partial
// sums to ws[bz][M][N].
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
nf4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scales, T* __restrict__ out,
                  float* __restrict__ ws, int M, int K, int N, int rows_per_split) {
  constexpr int UNROLL = ROWS <= 4 ? 8 : 4;  // rows a warp keeps in flight
  __shared__ float code[16];
  __shared__ float xs[ROWS][kChunk];
  __shared__ float red[kWarps][8][32];

  const int P = N / 2;
  const int scale_cols = P / 64;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kTileBytes + 4 * lane;  // the lane's first byte column
  const bool live = col < P;
  const int m0 = blockIdx.y * ROWS;
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);
  const float* scale_lo = scales;                 // plane 0: columns 0..P-1
  const float* scale_hi = scales + (size_t)K * scale_cols;  // plane 1: P..N-1

  if (threadIdx.x < 16) code[threadIdx.x] = kNf4[threadIdx.x];

  float acc[ROWS][8];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[m][i] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    const int rows = min(kChunk, k_end - k0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < ROWS * kChunk; e += kThreads) {
      const int m = e / kChunk, r = e % kChunk;
      xs[m][r] = (m0 + m < M && r < rows)
                     ? Cvt<T>::to_f(x[(size_t)(m0 + m) * K + k0 + r]) : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    for (int r0 = warp; r0 < rows; r0 += kWarps * UNROLL) {
      uint32_t word[UNROLL];
      float s_lo[UNROLL], s_hi[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r0 + u * kWarps;
        word[u] = 0u;
        s_lo[u] = s_hi[u] = 0.0f;
        if (r < rows) {
          const int k = k0 + r;
          word[u] = __ldg(reinterpret_cast<const uint32_t*>(packed + (size_t)k * P + col));
          s_lo[u] = __ldg(scale_lo + (size_t)k * scale_cols + col / 64);
          s_hi[u] = __ldg(scale_hi + (size_t)k * scale_cols + col / 64);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r0 + u * kWarps;
        if (r >= rows) break;
        float w[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t byte = (word[u] >> (8 * i)) & 0xFFu;
          w[i] = code[byte >> 4] * s_lo[u];       // column col + i
          w[4 + i] = code[byte & 0xFu] * s_hi[u];  // column P + col + i
        }
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const float xv = xs[m][r];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[m][i] = fmaf(xv, w[i], acc[m][i]);
        }
      }
    }
  }

  // the warps' partial sums, added in warp order; warp w then writes the
  // lane's outputs 2w and 2w + 1 of each row
  const int i0 = 2 * warp;
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp][i][lane] = acc[m][i];
    __syncthreads();
    if (!live || m0 + m >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][i0 + j][lane];
      const int n = (i0 < 4) ? col + i0 + j : P + col + i0 - 4 + j;
      const size_t at = (size_t)(m0 + m) * N + n;
      if (gridDim.z == 1) {
        out[at] = Cvt<T>::from_f(s);
      } else {
        ws[(size_t)blockIdx.z * M * N + at] = s;
      }
    }
  }
}

// out[i] = sum over s of ws[s][i], in split order, cast to T.
template <typename T>
__global__ void nf4_splitk_sum_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                      size_t count, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += ws[(size_t)z * count + i];
    out[i] = Cvt<T>::from_f(s);
  }
}

template <typename T, int ROWS>
int launch_rows(cudaStream_t stream, const void* x, const void* packed, const void* scales,
                void* out, void* ws, int M, int K, int N, int splits, int rows_per_split) {
  const int P = N / 2;
  const dim3 grid((P + kTileBytes - 1) / kTileBytes, (M + ROWS - 1) / ROWS, splits);
  nf4_matmul_kernel<T, ROWS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<T*>(out), static_cast<float*>(ws),
      M, K, N, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t count = (size_t)M * N;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  nf4_splitk_sum_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                       static_cast<T*>(out), count, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_rows(cudaStream_t stream, const void* x, const void* packed, const void* scales,
                  void* out, void* ws, int M, int K, int N, int splits, int rows_per_split) {
  if (M <= 1) return launch_rows<T, 1>(stream, x, packed, scales, out, ws, M, K, N, splits, rows_per_split);
  if (M <= 2) return launch_rows<T, 2>(stream, x, packed, scales, out, ws, M, K, N, splits, rows_per_split);
  if (M <= 4) return launch_rows<T, 4>(stream, x, packed, scales, out, ws, M, K, N, splits, rows_per_split);
  if (M <= 8) return launch_rows<T, 8>(stream, x, packed, scales, out, ws, M, K, N, splits, rows_per_split);
  return launch_rows<T, kMaxRows>(stream, x, packed, scales, out, ws, M, K, N, splits, rows_per_split);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (x and out). x [M, K], packed
// [K, N/2] uint8, scales [2, K, N/128] fp32, out [M, N]; ws [splits, M, N]
// fp32 when splits > 1. Needs N % 128 == 0 and 4-byte aligned rows. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int nf4_matmul(int device, void* stream, int dtype, const void* x,
                          const void* packed, const void* scales, void* out, void* ws,
                          int M, int K, int N, int splits, int rows_per_split) {
  if (M < 1 || K < 1 || N < 128 || N % 128 || splits < 1 || rows_per_split < 1 ||
      (long long)splits * rows_per_split < K || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_rows<float>(s, x, packed, scales, out, ws, M, K, N, splits, rows_per_split);
    case 1: return dispatch_rows<__nv_bfloat16>(s, x, packed, scales, out, ws, M, K, N, splits, rows_per_split);
    case 2: return dispatch_rows<__half>(s, x, packed, scales, out, ws, M, K, N, splits, rows_per_split);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* nf4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

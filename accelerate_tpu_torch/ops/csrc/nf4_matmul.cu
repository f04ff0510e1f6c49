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
// result that the wrapper concatenates and casts. Here K is split over the
// CTAs of one thread-block cluster, and the cluster sums their fp32 partials
// through distributed shared memory in split order inside the one launch: no
// workspace, no second pass, no atomics, so the sum is the same in every run.
//
// Bound: at decode M (1..16) the product is bound by bytes: the 4-bit payload
// plus one fp32 scale per 64 weights, K * N * (0.5 + 4 / 64) bytes, 9.4 MB at
// a 4096 x 4096 weight, 2.8 us at the H100 SXM's 3.35 TB/s (data sheet). Past
// about 10 rows the fp32 multiply-adds on the CUDA cores (67 TFLOP/s) bound it
// instead: the dequantized weight stays fp32, as in the TPU kernel.
// What the design does about it:
//   - grid (splits, ceil(P / 128), ceil(M / ROWS)), cluster (splits, 1, 1):
//     a CTA owns 128 byte columns of the plane (256 outputs, columns c..c+127
//     and P+c..P+c+127), ROWS rows of x (the next power of two of M, at most
//     16) and the cluster rank's run of K rows; the wrapper's `split_k` picks
//     the splits so the grid fills the card;
//   - the run streams through a ring of kStages stages of shared memory, each
//     [kStageRows, 128 bytes] of the plane (one TMA box, completing on the
//     stage's mbarrier) with its rows' four scales (two planes x two 64-column
//     blocks, by cp.async), so kStages - 1 stages of bytes are in flight while
//     one is computed; rows past K load as zeros;
//   - the run's x rows are staged once in shared memory, fp32, with 16-byte
//     loads where x's rows allow, and read as float4 broadcasts;
//   - a thread owns 4 adjacent byte columns, so every byte it reads yields
//     both planes' weights, and a warp reads one 128-byte row segment; a warp
//     takes 4 rows at a time and reuses each dequantized weight across the
//     ROWS rows of x from registers; the 16-entry codebook sits in shared
//     memory (32 lanes hit 16 banks); one fp32 scale covers a lane's 4
//     columns of a plane;
//   - the 4 warps' partials are added in warp order in shared memory; after
//     a cluster barrier each CTA sums one slice of the tile over the
//     cluster's partials (distributed shared memory, rank order) and writes
//     it in x's dtype; a second cluster barrier keeps every CTA's partial
//     alive until its peers have read it.
//
// The C entry point allocates nothing, never synchronises and reads no device
// data on the host, so a CUDA graph can capture it; it returns
// cudaGetLastError() after the launch, and the Python wrapper
// (accelerate_tpu_torch/ops/nf4_matmul.py) raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = 128;   // byte columns of a CTA: 32 lanes x 4 bytes
constexpr int kTileOut = 2 * kTileBytes;  // outputs a row of the tile
constexpr int kMaxRows = 16;      // M rows of a CTA
constexpr int kStageRows = 32;    // K rows a ring stage holds: 8 a warp
constexpr int kStages = 6;        // ring depth
constexpr int kRingOff = 128;     // the codebook sits first in shared memory, the ring after it
constexpr int kGroupRows = 4;     // K rows a warp takes at a time
constexpr int kStageBytes = kStageRows * kTileBytes + kStageRows * 4 * sizeof(float);
constexpr int kMaxSplits = 16;    // CTAs a cluster (past 8: the non-portable size)
constexpr size_t kXBudget = 96 * 1024;  // shared memory for the staged x rows

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

struct Params {
  CUtensorMap plane;       // the [K, P] plane in boxes of kStageRows x 128 bytes
  const void* x;           // [M, K] in T
  const float* scales;     // [2, K, P / 64] fp32
  void* out;               // [M, N] in T
  int M, K, N;
  int rows_per_split;      // K rows of a cluster rank (a multiple of 8 past one rank)
  int xcap;                // staged x row length (rows_per_split rounded up to 8)
  int x_off;               // byte offset of the staged x rows
  int x_vec;               // x rows load as 16-byte pieces
};

// CTA (rank, by, bz) of its cluster computes rows [bz * ROWS, +ROWS) of x
// against byte columns [by * 128, +128) over K rows [rank * rows_per_split,
// +rows_per_split); the cluster's sum of those partials is written to out.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads) nf4_matmul_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem_base[];
  // the codebook first in the dynamic block: a lookup's address is the
  // nibble times 4 plus a constant
  float* code = reinterpret_cast<float*>(smem_base);
  unsigned char* smem = smem_base + kRingOff;
  __shared__ __align__(8) uint64_t full[kStages];  // a stage's plane rows have landed

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = static_cast<int>(cluster_ctarank());
  const int splits = static_cast<int>(cluster_nctarank());
  const int P = p.N / 2;
  const int scale_cols = P / 64;
  const int c0 = blockIdx.y * kTileBytes;  // the tile's first byte column
  const int m0 = blockIdx.z * ROWS;
  const int k0 = min(p.K, split * p.rows_per_split);
  const int k1 = min(p.K, k0 + p.rows_per_split);
  const int nrows = k1 - k0;
  const int nst = (nrows + kStageRows - 1) / kStageRows;

  if (tid < 16) code[tid] = kNf4[tid];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage s: plane rows [k0 + s * kStageRows, +kStageRows) of the tile by TMA
  // (rows past K and columns past P land as zeros; rows past the run meet
  // zeros in x), then each row's scales by cp.async: plane 0's blocks of the
  // tile, then plane 1's, 8 bytes a plane where both blocks exist
  auto issue = [&](int s) {
    const int slot = s % kStages;
    unsigned char* st = smem + slot * kStageBytes;
    float* ss = reinterpret_cast<float*>(st + kStageRows * kTileBytes);
    const int kb = k0 + s * kStageRows;
    if (tid == 0) {
      mbar_expect_tx(full + slot, kStageRows * kTileBytes);
      tma_load(st, &p.plane, full + slot, c0, kb, 0);
    }
    if (tid < 2 * kStageRows) {
      const int r = tid >> 1;
      const int plane = tid & 1;
      const int k = kb + r;
      const int blk = c0 / 64;
      const float* src = p.scales + (static_cast<size_t>(plane) * p.K + k) * scale_cols + blk;
      float* dst = ss + r * 4 + 2 * plane;
      if (scale_cols % 2 == 0) {  // rows of whole 8-byte pairs
        cp_async<8>(dst, k < k1 ? src : p.scales, k < k1);
      } else {
        cp_async<4>(dst, k < k1 ? src : p.scales, k < k1);
        const bool second = k < k1 && blk + 1 < scale_cols;
        cp_async<4>(dst + 1, second ? src + 1 : p.scales, second);
      }
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }

  // x rows [m0, m0 + ROWS) x the run's K rows, fp32, zero past M and K
  float* xs = reinterpret_cast<float*>(smem + p.x_off);
  const T* xg = static_cast<const T*>(p.x);
  if (p.x_vec) {
    constexpr int VE = 16 / sizeof(T);
    const int per_row = p.xcap / VE;
    for (int i = tid; i < ROWS * per_row; i += kThreads) {
      const int m = i / per_row;
      const int r = (i - m * per_row) * VE;
      float v[VE];
      if (m0 + m < p.M && r < nrows) {  // whole pieces: K and the run start are multiples of VE
        const T* src = xg + static_cast<size_t>(m0 + m) * p.K + k0 + r;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
        T vals[VE];
        memcpy(vals, &raw, sizeof(raw));
#pragma unroll
        for (int e = 0; e < VE; ++e) v[e] = Cvt<T>::to_f(vals[e]);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) v[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) xs[m * p.xcap + r + e] = v[e];
    }
  } else {
    for (int i = tid; i < ROWS * p.xcap; i += kThreads) {
      const int m = i / p.xcap;
      const int r = i - m * p.xcap;
      xs[i] = (m0 + m < p.M && r < nrows) ? Cvt<T>::to_f(xg[static_cast<size_t>(m0 + m) * p.K + k0 + r])
                                           : 0.0f;
    }
  }

  float acc[ROWS][8];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[m][i] = 0.0f;
  const bool live = c0 + 4 * lane < P;
  const int sb = lane >> 4;  // the lane's 64-column scale block within the tile

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    mbar_wait(full + s % kStages, (s / kStages) & 1);
    __syncthreads();  // stage s (and, at s 0, x) is in; slot s - 1 is free
    if (s + kStages - 1 < nst) issue(s + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (s % kStages) * kStageBytes;
    const float* ss = reinterpret_cast<const float*>(st + kStageRows * kTileBytes);
    const int nr = min(kStageRows, nrows - s * kStageRows);
    const float* xk = xs + s * kStageRows;
    if (!live) continue;
#pragma unroll
    for (int gi = 0; gi < kStageRows / kWarps / kGroupRows; ++gi) {
      const int r0 = warp * (kStageRows / kWarps) + gi * kGroupRows;
      if (r0 >= nr) break;  // rows past the run meet zeros in x: skipping them changes nothing
      uint32_t word[kGroupRows];
      float2 sc[kGroupRows];
#pragma unroll
      for (int u = 0; u < kGroupRows; ++u) {
        word[u] = *reinterpret_cast<const uint32_t*>(st + (r0 + u) * kTileBytes + 4 * lane);
        sc[u] = make_float2(ss[(r0 + u) * 4 + sb], ss[(r0 + u) * 4 + 2 + sb]);
      }
      float w[kGroupRows][8];
#pragma unroll
      for (int u = 0; u < kGroupRows; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t byte = (word[u] >> (8 * i)) & 0xFFu;
          w[u][i] = code[byte >> 4] * sc[u].x;        // column c + i
          w[u][4 + i] = code[byte & 0xFu] * sc[u].y;  // column P + c + i
        }
      }
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xk + m * p.xcap + r0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float a = acc[m][i];
          a = fmaf(xv.x, w[0][i], a);
          a = fmaf(xv.y, w[1][i], a);
          a = fmaf(xv.z, w[2][i], a);
          a = fmaf(xv.w, w[3][i], a);
          acc[m][i] = a;
        }
      }
    }
  }

  // the warps' partials, added in warp order into warp 0's slot
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][ROWS][kTileOut]
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    float* r = red + (warp * ROWS + m) * kTileOut + 4 * lane;
    *reinterpret_cast<float4*>(r) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    *reinterpret_cast<float4*>(r + kTileBytes) = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * kTileOut; i += kThreads) {
    float s = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * ROWS * kTileOut + i];
    red[i] = s;
  }

  // every CTA's partial is in its shared memory: each CTA sums one slice of
  // the tile over the cluster's ranks 0, 1, ... in turn (one rank: its own
  // partial, no cluster barrier)
  if (splits > 1) cluster_sync();
  else __syncthreads();
  const int nout = ROWS * kTileOut;
  const int slice = (nout + splits - 1) / splits;
  const int lo = split * slice;
  const int hi = min(nout, lo + slice);
  T* out = static_cast<T*>(p.out);
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int m = i / kTileOut;
    const int j = i - m * kTileOut;
    const int col = c0 + (j % kTileBytes);
    if (m0 + m >= p.M || col >= P) continue;
    float part[kMaxSplits];  // every rank's load in flight before the sum
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) part[r] = r < splits ? ld_dsmem(red + i, r) : 0.0f;
    float s = part[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r) s += part[r];
    out[static_cast<size_t>(m0 + m) * p.N + (j < kTileBytes ? col : P + col)] = Cvt<T>::from_f(s);
  }
  if (splits > 1) cluster_sync();  // no CTA leaves while a peer may still read its partial
}

// a TMA map over the [K, P] uint8 plane in boxes of kStageRows rows x 128
// bytes, unswizzled; boxes past the plane's edges load zeros
CUresult plane_map(CUtensorMap* map, const void* packed, int K, int P) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(P), static_cast<cuuint64_t>(K), 1};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(P),
                                 static_cast<cuuint64_t>(P) * static_cast<cuuint64_t>(K)};
  const cuuint32_t box[3] = {kTileBytes, kStageRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(packed), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int ROWS>
int launch(Params p, int splits, cudaStream_t stream) {
  const size_t ring = static_cast<size_t>(kStages) * kStageBytes;
  const size_t xbytes = static_cast<size_t>(ROWS) * p.xcap * sizeof(float);
  const size_t red = static_cast<size_t>(kWarps) * ROWS * kTileOut * sizeof(float);
  const size_t smem = kRingOff + std::max(ring + xbytes, red);
  if (smem + kStages * sizeof(uint64_t) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  p.x_off = static_cast<int>(ring);
  auto kernel = nf4_matmul_kernel<T, ROWS>;
  static const cudaError_t prepared = allow_max_smem(kernel);
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  const int P = p.N / 2;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(splits, (P + kTileBytes - 1) / kTileBytes, (p.M + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
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

// ROWS: the next power of two of M, at most 16, halved while the staged x
// rows would not fit their budget
template <typename T>
int dispatch_rows(Params p, int splits, cudaStream_t stream) {
  int rows = 1;
  while (rows < p.M && rows < kMaxRows) rows *= 2;
  while (rows > 1 && static_cast<size_t>(rows) * p.xcap * sizeof(float) > kXBudget) rows /= 2;
  if (static_cast<size_t>(rows) * p.xcap * sizeof(float) > kXBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  p.x_vec = (static_cast<size_t>(p.K) * sizeof(T)) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  switch (rows) {
    case 1: return launch<T, 1>(p, splits, stream);
    case 2: return launch<T, 2>(p, splits, stream);
    case 4: return launch<T, 4>(p, splits, stream);
    case 8: return launch<T, 8>(p, splits, stream);
    default: return launch<T, kMaxRows>(p, splits, stream);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (x and out). x [M, K], packed
// [K, N/2] uint8 (16-byte aligned), scales [2, K, N/128] fp32, out [M, N].
// `splits` CTAs of a cluster (at most 16) split K into runs of
// `rows_per_split` rows, a multiple of 8 when there is more than one. Needs
// N % 128 == 0. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int nf4_matmul(int device, void* stream, int dtype, const void* x,
                          const void* packed, const void* scales, void* out,
                          int M, int K, int N, int splits, int rows_per_split) {
  if (M < 1 || K < 1 || N < 128 || N % 128 || splits < 1 || splits > kMaxSplits ||
      rows_per_split < 1 || (long long)splits * rows_per_split < K ||
      (splits > 1 && rows_per_split % 8) || reinterpret_cast<uintptr_t>(packed) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params p{};
  p.x = x;
  p.scales = static_cast<const float*>(scales);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.rows_per_split = rows_per_split;
  p.xcap = (std::min(rows_per_split, K) + 7) / 8 * 8;
  const CUresult mapped = plane_map(&p.plane, packed, K, N / 2);
  if (mapped != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_rows<float>(p, splits, s);
    case 1: return dispatch_rows<__nv_bfloat16>(p, splits, s);
    case 2: return dispatch_rows<__half>(p, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* nf4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Batched slice covariance C_i = T_i^T T_i for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gram.py:_gram_kernel (the Pallas TPU kernel
// behind batched_gram), the paper's Alg. 1 line 1.
//
// What it computes: for each of n slices T (r x c, fp32 or bf16, row-major)
// the c x c matrix C[i][j] = sum_k T[k][i] * T[k][j], products and sums in
// fp32 (a product of two bf16 values is exact in fp32, so only the order of
// the sums differs from the TPU's), written as fp32 or bf16.  Both
// triangles are written, as the TPU kernel does.
//
// What bounds it on this card: operations in fp32, bytes in bf16.  C is
// symmetric, so the function needs only the c(c+1)/2 entries of one
// triangle: n*r*c*(c+1) flops.  At the main path's n = r = c = 1000 that
// is 1.0e12 flops per mode, 14.9 ms at the 67 TFLOP/s of the fp32 CUDA
// cores, against 8 GB of bytes in fp32 (4 GB in, 4 GB out: 2.4 ms at
// 3.35 TB/s).  In bf16 the same flops take 1.0 ms at the 989 TFLOP/s of the
// tensor cores, so its 6 GB of bytes bound it (1.8 ms).  This kernel does
// 2*n*r*c^2 flops, both triangles in full.
//
// What the design does about it: a classic register-tiled product on the
// CUDA cores.  Each CTA owns one 128 x 128 tile of one slice's C; the TPU's
// sequential row-tile grid axis becomes a loop inside the CTA over 8-row
// tiles of T, each staged in shared memory (converted to fp32 there, which
// is exact for bf16) and double-buffered: the next tile is fetched into
// registers while the current one is multiplied, so one barrier per step
// suffices.  Each of the 256 threads keeps an 8 x 8 block of C in registers
// and reads its operands as float4 from shared memory (64 FMAs per four
// 16-byte loads).  The 64 CTAs of one slice are adjacent in the launch
// order, so a slice (4 MB at c = r = 1000 in fp32) is read from device
// memory about once and then from L2.  Ragged r and c are masked at the
// loads (missing elements read as 0, so zero rows and columns add exact
// zeros) and at the stores.  Every offset into T and C is size_t: n*c*c
// passes 2^31 at c >= 1291.  The reference's block_r / block_c hints are
// not used.  Not yet used: wgmma (the tensor cores), TMA, computing one
// triangle only and mirroring it (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 128;  // C tile edge (rows and columns)
constexpr int BK = 8;    // rows of T per staged step
constexpr int TM = 8;    // per-thread C block edge
constexpr int kThreads = (BM / TM) * (BM / TM);  // 256
constexpr int kLoads = BK * BM / kThreads;       // 4 elements per operand

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, 2)
gram_kernel(const Tin* __restrict__ t, Tout* __restrict__ out, int n, int r,
            int c, int tiles) {
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][BK][BM];

  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM), ty = tid / (BM / TM);
  const int i0 = (blockIdx.x / tiles) * BM, j0 = (blockIdx.x % tiles) * BM;
  // staging: thread tid loads column tid % BM of rows tid / BM + 2q
  const int lcol = tid % BM, lrow = tid / BM;
  const bool a_in = i0 + lcol < c, b_in = j0 + lcol < c;

  for (int g = blockIdx.y; g < n; g += gridDim.y) {
    const Tin* ts = t + static_cast<size_t>(g) * r * c;
    float ra[kLoads], rb[kLoads];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int k = k0 + lrow + q * (kThreads / BM);
        const size_t row = static_cast<size_t>(k) * c;
        ra[q] = (k < r && a_in) ? to_f(ts[row + i0 + lcol]) : 0.f;
        rb[q] = (k < r && b_in) ? to_f(ts[row + j0 + lcol]) : 0.f;
      }
    };
    auto stage = [&](int buf) {
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        as[buf][lrow + q * (kThreads / BM)][lcol] = ra[q];
        bs[buf][lrow + q * (kThreads / BM)][lcol] = rb[q];
      }
    };

    float acc[TM][TM];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TM; ++b) acc[a][b] = 0.f;

    fetch(0);
    stage(0);
    __syncthreads();
    int cur = 0;
    for (int k0 = 0; k0 < r; k0 += BK) {
      const bool more = k0 + BK < r;
      if (more) fetch(k0 + BK);
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][k][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[cur][k][BM / 2 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[cur][k][BM / 2 + tx * 4]);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TM; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
      if (more) stage(cur ^ 1);
      __syncthreads();
      cur ^= 1;
    }

    // thread (ty, tx) holds rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3},
    // and the same pattern of columns with tx
    Tout* os = out + static_cast<size_t>(g) * c * c;
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int i = i0 + (a < 4 ? ty * 4 + a : BM / 2 + ty * 4 + a - 4);
      if (i >= c) continue;
#pragma unroll
      for (int b = 0; b < TM; ++b) {
        const int j = j0 + (b < 4 ? tx * 4 + b : BM / 2 + tx * 4 + b - 4);
        if (j < c) os[static_cast<size_t>(i) * c + j] = from_f<Tout>(acc[a][b]);
      }
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* t, void* out, int n, int r, int c,
                   cudaStream_t stream) {
  if (n < 0 || r < 0 || c < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int tiles = (c + BM - 1) / BM;
  const dim3 grid(tiles * tiles, n < 65535 ? n : 65535);
  gram_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(t), static_cast<Tout*>(out), n, r, c, tiles);
  return cudaGetLastError();
}

}  // namespace

// in_dtype, out_dtype: 0 = float32, 1 = bfloat16.  Device pointers to
// contiguous tensors: t (n, r, c), out (n, c, c).  Returns a cudaError_t
// (0 = launched).
extern "C" int msc_gram(int device, int in_dtype, int out_dtype,
                        const void* t, void* out, int n, int r, int c,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(t, out, n, r, c, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(t, out, n, r, c, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(t, out, n, r, c, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(t, out, n, r, c, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* msc_gram_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

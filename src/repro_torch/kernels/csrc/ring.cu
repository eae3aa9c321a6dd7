// Fused |A B^T| row-sum for NVIDIA Hopper (sm_90a): the similarity epilogue.
//
// Replaces: src/repro/kernels/ring.py:_abs_rowsum_kernel (the Pallas TPU
// kernel behind abs_rowsum).
//
// What it computes: out[i] = acc[i] + sum_j |a[i,:] . b[j,:]| with a (bl, c),
// b (bc, c) in fp32 or bf16, products and sums in fp32, acc (bl,) fp32 or
// absent.  The batched form takes a (B, bl, c), b (B, bc, c), acc (B, bl)
// and keeps requests apart (one grid row per request).
//
// What bounds it on this card: operations.  It does 2*bl*bc*c flops on
// (bl + bc)*c elements; at the main path's bl = bc = c = 1000 that is
// ~250 flops per fp32 byte, above the ~20 flops per byte where the H100's
// fp32 CUDA cores (67 TFLOP/s) stop waiting on 3.35 TB/s of memory.  The
// least time is 2*bl*bc*c / 67e12 s.  The bl x bc similarity tile is never
// written to memory.
//
// What the design does about it: one CTA per 32 rows of a loops over every
// 64-row tile of b inside the block (the TPU's sequential j grid axis
// becomes this loop), so each row-sum is finished by the one CTA that owns
// the row, deterministically and without atomics.  Both operands are
// staged through shared memory in 32-wide slices of c (converted to fp32
// there, which is exact for bf16), each thread keeps a 2 x 4 register tile
// of products, takes |.| and folds it into its two running row-sums; a
// 16-lane shuffle finishes the sums and acc is added once at the end.
// Ragged i, j and c edges are masked at the loads: missing elements read
// as 0, and zero rows of b add |0| = 0.  The block_i / block_j hints of
// the reference are not used: the tile is fixed at 32 x 64.  Not yet used:
// tensor cores (wgmma), TMA, double buffering (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BI = 32;  // rows of a per CTA
constexpr int BJ = 64;  // rows of b per inner tile
constexpr int BK = 32;  // slice of c staged per step
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
abs_rowsum_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ acc, float* __restrict__ out,
                  int bl, int bc, int c) {
  __shared__ float as[BK][BI + 1];
  __shared__ float bs[BK][BJ + 1];

  const size_t g = blockIdx.y;
  a += g * bl * static_cast<size_t>(c);
  b += g * bc * static_cast<size_t>(c);
  const int i0 = blockIdx.x * BI;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // rows ty, ty+16; cols tx+16q

  float rs[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < bc; j0 += BJ) {
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < c; k0 += BK) {
      for (int e = tid; e < BI * BK; e += kThreads) {
        const int i = e / BK, k = e % BK;
        const int gi = i0 + i, gk = k0 + k;
        as[k][i] = (gi < bl && gk < c)
                       ? to_f(a[static_cast<size_t>(gi) * c + gk]) : 0.f;
      }
      for (int e = tid; e < BJ * BK; e += kThreads) {
        const int j = e / BK, k = e % BK;
        const int gj = j0 + j, gk = k0 + k;
        bs[k][j] = (gj < bc && gk < c)
                       ? to_f(b[static_cast<size_t>(gj) * c + gk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float a0 = as[k][ty], a1 = as[k][ty + 16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float bv = bs[k][tx + 16 * q];
          s[0][q] = fmaf(a0, bv, s[0][q]);
          s[1][q] = fmaf(a1, bv, s[1][q]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
      rs[p] += (fabsf(s[p][0]) + fabsf(s[p][1])) +
               (fabsf(s[p][2]) + fabsf(s[p][3]));
  }
  // the 16 threads sharing ty sit in one half-warp: finish their sums
#pragma unroll
  for (int p = 0; p < 2; ++p)
    for (int o = 8; o > 0; o >>= 1)
      rs[p] += __shfl_xor_sync(0xffffffffu, rs[p], o);
  if (tx == 0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int gi = i0 + ty + 16 * p;
      if (gi < bl) {
        const size_t o = g * bl + gi;
        out[o] = (acc ? acc[o] : 0.f) + rs[p];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* acc, void* out,
                   int batch, int bl, int bc, int c, cudaStream_t stream) {
  if (batch < 0 || bl < 0 || bc < 0 || c < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  if (batch == 0 || bl == 0) return cudaSuccess;
  const dim3 grid((bl + BI - 1) / BI, batch);
  abs_rowsum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(acc), static_cast<float*>(out), bl, bc, c);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Device pointers to contiguous tensors:
// a (batch, bl, c), b (batch, bc, c), acc and out (batch, bl) fp32; acc may
// be NULL.  Returns a cudaError_t (0 = launched).
extern "C" int msc_abs_rowsum(int device, int dtype, const void* a,
                              const void* b, const void* acc, void* out,
                              int batch, int bl, int bc, int c,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, acc, out, batch, bl, bc, c, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, acc, out, batch, bl, bc, c, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* msc_abs_rowsum_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

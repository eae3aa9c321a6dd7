// Fused |A B^T| row-sum for NVIDIA Hopper (sm_90a): the similarity epilogue.
//
// Replaces: src/repro/kernels/ring.py:_abs_rowsum_kernel (the Pallas TPU
// kernel behind abs_rowsum).
//
// What it computes: out[i] = acc[i] + sum_j |a[i,:] . b[j,:]| with a (bl, c),
// b (bc, c) in fp32 or bf16, products and sums in fp32, acc (bl,) fp32 or
// absent.  The batched form takes a (B, bl, c), b (B, bc, c), acc (B, bl)
// and keeps requests apart.
//
// What bounds it on this card: operations.  It does 2*bl*bc*c flops on
// (bl + bc)*c elements; at the main path's bl = bc = c = 1000 that is
// ~250 flops per fp32 byte, above the ~20 flops per byte where the fp32
// CUDA cores (67 TFLOP/s) stop waiting on 3.35 TB/s of memory, and in bf16
// ~500 per byte, above the tensor cores' ~295.  The bl x bc similarity
// tile is never written to memory.
//
// What the design does about it:
// - The grid covers (i-tile, j-tile, request) with 64 x 64 tiles, the
//   request on grid.z: 16 x 16 = 256 CTAs at bl = bc = 1000, two per SM,
//   where one CTA per i-tile left 100 of the 132 SMs idle.
// - Each CTA writes its tile's row partials sum_j |a b^T| to a workspace
//   (B, nj, bl).  The last CTA of each (request, i-tile), found by a ticket
//   taken with atomicAdd on a zeroed counter after __threadfence() (the
//   threadFenceReduction pattern), adds acc and the nj partials in j order.
//   The sum is the same bits from run to run (the trim and the max-gap
//   extraction read d), and a call stays one launch.
// - fp32: CUDA cores, an SGEMM register tile of 4 x 4 per thread (rows
//   ty + 16r, columns tx + 16c), k-slices of 32 double-buffered through
//   shared memory by cp.async and read as float4 along k.  Rows are padded
//   to 36 floats so eight lanes reading eight consecutive rows hit
//   distinct banks.
// - bf16: tensor cores, mma.sync.m16n8k16 bf16 -> fp32 with ldmatrix from
//   shared memory, k-slices of 64 double-buffered by cp.async, rows padded
//   by 16 B for conflict-free ldmatrix.  bf16 products are exact in fp32
//   and the sums are fp32: the Pallas body's arithmetic.  |.| and the row
//   sum are taken on the accumulator fragments and finished with quad
//   shuffles; each of the 8 warps owns 16 rows x 32 columns.
// - Loads are 16 bytes where c * sizeof(T) % 16 == 0 and both bases are
//   16-byte aligned (the VEC template flag); otherwise the same kernel
//   copies single elements (4-byte cp.async in fp32, plain loads in bf16).
//   Ragged i, j and c are zero-filled at the loads: zero rows of b add 0.
// The block_i / block_j hints of the reference are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int BI = 64;  // rows of a per CTA
constexpr int BJ = 64;  // rows of b per CTA
constexpr int kThreads = 256;

// fp32: k-slices of 32, rows padded to 36 floats (144 B)
constexpr int BK32 = 32;
constexpr int LD32 = BK32 + 4;
// bf16: k-slices of 64, rows padded to 72 elements (144 B)
constexpr int BK16 = 64;
constexpr int LD16 = BK16 + 8;

template <typename T, int BK, int LD>
struct Stage {
  T a[BI][LD];
  T b[BJ][LD];
};

// columns [k0, k0 + BK) of rows [r0, r0 + 64) of a (rows, c) operand into
// shared memory, zero past the edges
template <typename T, bool VEC, int BK, int LD>
__device__ __forceinline__ void load_rows(T (&dst)[BI][LD],
                                          const T* __restrict__ src, int r0,
                                          int rows, int k0, int c) {
  // 16 B chunks with VEC, else single elements
  constexpr int E = VEC ? 16 / sizeof(T) : 1;
  for (int e = threadIdx.x; e < BI * BK / E; e += kThreads) {
    const int row = e / (BK / E), kk = (e % (BK / E)) * E;
    const int gk = k0 + kk;
    const bool ok = r0 + row < rows && gk < c;
    const T* from = ok ? src + static_cast<size_t>(r0 + row) * c + gk : src;
    if constexpr (VEC)
      ptx::cp_async16(&dst[row][kk], from, ok ? 16 : 0);
    else if constexpr (sizeof(T) == 4)
      ptx::cp_async4(&dst[row][kk], from, ok ? 4 : 0);
    else  // no 2-byte cp.async: a plain load
      dst[row][kk] = ok ? *from : T(0.f);
  }
}

// one k-slice of the a and b tiles
template <typename T, bool VEC, int BK, int LD>
__device__ __forceinline__ void load_slice(Stage<T, BK, LD>& st,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b, int i0,
                                           int j0, int k0, int bl, int bc,
                                           int c) {
  load_rows<T, VEC, BK>(st.a, a, i0, bl, k0, c);
  load_rows<T, VEC, BK>(st.b, b, j0, bc, k0, c);
}

// the CTA's row partials sum_j |a b^T| over its 64 columns, into part[]
template <bool VEC>
__device__ void tile_fp32(const float* __restrict__ a,
                          const float* __restrict__ b, int i0, int j0, int bl,
                          int bc, int c, float* part) {
  __shared__ __align__(16) Stage<float, BK32, LD32> st[2];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float s[4][4] = {};
  const int nk = (c + BK32 - 1) / BK32;
  load_slice<float, VEC>(st[0], a, b, i0, j0, 0, bl, bc, c);
  ptx::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load_slice<float, VEC>(st[(kt + 1) & 1], a, b, i0, j0, (kt + 1) * BK32,
                             bl, bc, c);
    ptx::cp_async_commit();
    ptx::cp_async_wait<1>();
    __syncthreads();
    const Stage<float, BK32, LD32>& cur = st[kt & 1];
#pragma unroll
    for (int k4 = 0; k4 < BK32; k4 += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(&cur.a[ty + 16 * r][k4]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bv[q] = *reinterpret_cast<const float4*>(&cur.b[tx + 16 * q][k4]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[r][q] = fmaf(av[r].x, bv[q].x, s[r][q]);
          s[r][q] = fmaf(av[r].y, bv[q].y, s[r][q]);
          s[r][q] = fmaf(av[r].z, bv[q].z, s[r][q]);
          s[r][q] = fmaf(av[r].w, bv[q].w, s[r][q]);
        }
    }
    __syncthreads();  // the slice is free for the next step's load
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float rs = (fabsf(s[r][0]) + fabsf(s[r][1])) +
               (fabsf(s[r][2]) + fabsf(s[r][3]));
    // the 16 lanes sharing ty sit in one half-warp
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
    if (tx == 0) part[ty + 16 * r] = rs;
  }
}

template <bool VEC>
__device__ void tile_bf16(const __nv_bfloat16* __restrict__ a,
                          const __nv_bfloat16* __restrict__ b, int i0, int j0,
                          int bl, int bc, int c, float* part) {
  __shared__ __align__(16) Stage<__nv_bfloat16, BK16, LD16> st[2];
  __shared__ float red[2][BI];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wm = w & 3, wn = w >> 2;  // rows 16 wm, columns 32 wn
  float cf[4][4] = {};                // four n8 tiles of C
  const int nk = (c + BK16 - 1) / BK16;
  load_slice<__nv_bfloat16, VEC>(st[0], a, b, i0, j0, 0, bl, bc, c);
  ptx::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load_slice<__nv_bfloat16, VEC>(st[(kt + 1) & 1], a, b, i0, j0,
                                     (kt + 1) * BK16, bl, bc, c);
    ptx::cp_async_commit();
    ptx::cp_async_wait<1>();
    __syncthreads();
    const Stage<__nv_bfloat16, BK16, LD16>& cur = st[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      uint32_t af[4];
      ptx::ldmatrix_x4(af, &cur.a[16 * wm + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bf[4];
        ptx::ldmatrix_x4(
            bf, &cur.b[32 * wn + 16 * p + (lane & 7) + (lane >> 4) * 8]
                      [kk + ((lane >> 3) & 1) * 8]);
        ptx::mma_bf16(cf[2 * p], af, bf[0], bf[1]);
        ptx::mma_bf16(cf[2 * p + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
  float r0 = 0.f, r8 = 0.f;  // rows g and g + 8 of the warp's 16
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    r0 += fabsf(cf[n][0]) + fabsf(cf[n][1]);
    r8 += fabsf(cf[n][2]) + fabsf(cf[n][3]);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    r0 += __shfl_xor_sync(0xffffffffu, r0, o);
    r8 += __shfl_xor_sync(0xffffffffu, r8, o);
  }
  if ((lane & 3) == 0) {
    red[wn][16 * wm + (lane >> 2)] = r0;
    red[wn][16 * wm + (lane >> 2) + 8] = r8;
  }
  __syncthreads();
  if (threadIdx.x < BI) part[threadIdx.x] = red[0][threadIdx.x] +
                                            red[1][threadIdx.x];
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
abs_rowsum_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ acc, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ tickets, int bl,
                  int bc, int c) {
  __shared__ float part[BI];
  __shared__ int last;
  const int it = blockIdx.x, jt = blockIdx.y, ni = gridDim.x, nj = gridDim.y;
  const size_t g = blockIdx.z;
  a += g * bl * static_cast<size_t>(c);
  b += g * bc * static_cast<size_t>(c);
  const int i0 = it * BI, j0 = jt * BJ;
  if constexpr (sizeof(T) == 4)
    tile_fp32<VEC>(a, b, i0, j0, bl, bc, c, part);
  else
    tile_bf16<VEC>(a, b, i0, j0, bl, bc, c, part);
  __syncthreads();

  const int tid = threadIdx.x, gi = i0 + tid;
  if (tid < BI && gi < bl) ws[(g * nj + jt) * bl + gi] = part[tid];
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[g * ni + it], 1) == nj - 1;
  __syncthreads();
  if (!last || tid >= BI || gi >= bl) return;
  // the last CTA of this (request, i-tile): acc, then the partials in j
  // order, read from L2 (__ldcg) where the other CTAs left them
  float v = acc ? acc[g * bl + gi] : 0.f;
  for (int j = 0; j < nj; ++j) v += __ldcg(&ws[(g * nj + j) * bl + gi]);
  out[g * bl + gi] = v;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* acc, void* out,
                   void* ws, void* tickets, int nj, int batch, int bl, int bc,
                   int c, cudaStream_t stream) {
  if (batch < 0 || bl < 0 || bc < 0 || c < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  // the workspace and the tickets were sized by the wrapper's tile plan
  // (bc = 0 takes one j-tile of zero rows)
  if (nj != (bc > 0 ? (bc + BJ - 1) / BJ : 1) || nj > 65535)
    return cudaErrorInvalidValue;
  if (batch == 0 || bl == 0) return cudaSuccess;
  const dim3 grid((bl + BI - 1) / BI, nj, batch);
  const bool vec = (static_cast<size_t>(c) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const float*>(acc), static_cast<float*>(out),
        static_cast<float*>(ws), static_cast<int*>(tickets), bl, bc, c);
  };
  if (vec)
    args(abs_rowsum_kernel<T, true>);
  else
    args(abs_rowsum_kernel<T, false>);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Device pointers to contiguous tensors:
// a (batch, bl, c), b (batch, bc, c), acc and out (batch, bl) fp32; acc may
// be NULL.  ws is fp32 scratch of (batch, nj, bl) and tickets int32 of
// (batch, ceil(bl / 64)) set to 0, with nj = max(1, ceil(bc / 64)).  Returns a
// cudaError_t (0 = launched).
extern "C" int msc_abs_rowsum(int device, int dtype, const void* a,
                              const void* b, const void* acc, void* out,
                              void* ws, void* tickets, int nj, int batch,
                              int bl, int bc, int c, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, acc, out, ws, tickets, nj, batch, bl, bc, c,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, acc, out, ws, tickets, nj, batch, bl,
                                 bc, c, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* msc_abs_rowsum_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

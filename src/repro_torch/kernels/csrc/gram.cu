// Batched slice covariance C_i = T_i^T T_i for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gram.py:_gram_kernel (the Pallas TPU kernel
// behind batched_gram), the paper's Alg. 1 line 1.
//
// What it computes: for each of n slices T (r x c, fp32 or bf16, row-major)
// the c x c matrix C[i][j] = sum_k T[k][i] * T[k][j], products and sums in
// fp32 (a product of two bf16 values is exact in fp32, so only the order of
// the sums differs from the TPU's), written as fp32 or bf16.  Both
// triangles are written, as the TPU kernel does.  No TF32 anywhere.
//
// What bounds it on this card: operations in fp32, bytes in bf16.  C is
// symmetric, so the function needs only the c(c+1)/2 entries of one
// triangle: n*r*c*(c+1) flops.  At the main path's n = r = c = 1000 that
// is 1.0e12 flops per mode, 14.9 ms at the 67 TFLOP/s of the fp32 CUDA
// cores, against 8 GB of bytes in fp32 (4 GB in, 4 GB out: 2.4 ms at
// 3.35 TB/s).  In bf16 the same flops take 1.0 ms at the 989 TFLOP/s of the
// tensor cores, so its 6 GB of bytes bound it (1.8 ms).
//
// What the design does about it:
// - One triangle.  The grid covers the 128 x 128 tile pairs (ti <= tj) of
//   each slice, tiles(tiles+1)/2 of them (36 at c = 1000, where both
//   triangles took 64), enumerated row by row by tile_pair() (mirrored in
//   Python as gram.tile_plan).  An off-diagonal CTA writes C[ti][tj] and
//   its mirror C[tj][ti]; the accumulators go through a padded tile in
//   shared memory, so both stores are whole rows (a warp stores 32
//   consecutive entries).  A diagonal CTA loads its one operand tile once.
//   The CTAs of one slice are adjacent in the launch order, so a slice is
//   read from device memory about once and then from L2.  The slice loop
//   over gridDim.y stays, since n can pass 65535.
// - Asynchronous 16-byte loads.  Rows of T are the contraction axis: each
//   stage holds 32 rows x 128 columns of the i- and j-blocks, copied by
//   cp.async 16 bytes at a time into a ring of stages (3 in fp32, 4 in
//   bf16), with one barrier per stage.  Rows whose pitch c * elt is not a
//   multiple of 16 bytes (or a base that is not 16-byte aligned) take
//   single-element copies (the VEC template flag, as in ring.cu).  Ragged
//   r and c read as zeros and are masked at the stores.  Every offset into
//   T and C is size_t.  The epilogue tile reuses the stages' memory.
// - fp32: CUDA cores, fp32 FMAs.  Each of 256 threads keeps an 8 x 8
//   block of C in registers and reads its operands as float4 from shared
//   memory (64 FMAs per four 16-byte loads); two CTAs per SM.
// - bf16: tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> fp32 with the
//   accumulator in registers.  Both operands are k-major in shared memory
//   (T's rows), so both come through ldmatrix.trans, rows padded by 16
//   bytes so eight 16-byte rows hit distinct banks.  Four warps of 64 x 64
//   each (32 products per 12 ldmatrix), three CTAs per SM: on the H100,
//   when the layout was chosen, three CTAs with a few spilled registers
//   beat two without, and 64 x 64 warps beat eight of 64 x 32.
//   The kernel then sits between the two bounds: the operand traffic from
//   L2 (each CTA reads 2 x 128 columns of every row, ~16 MB per 2 MB slice
//   at c = 1000) and the mma.sync throughput, not the 1.8 ms of bytes.
// The reference's block_r / block_c hints are not used.  Not yet used:
// wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int BM = 128;  // C tile edge (rows and columns)
constexpr int kPitch = BM + 1;  // the epilogue tile: column reads hit
                                // distinct banks
constexpr int kEpiBytes = BM * kPitch * 4;

constexpr int TM = 8;   // fp32: per-thread C block edge
constexpr int kNT = 8;  // bf16: n8 mma tiles per warp (a warp owns 64 x 64)

// per operand type: threads per CTA, CTAs to fit on one SM (which caps the
// registers: 2 x 256 threads at <= 128, 3 x 128 at <= 168), rows of T per
// stage, the row pitch of a stage in shared memory (bf16 rows padded by
// 16 bytes for conflict-free ldmatrix) and the stages in the ring
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kThreads = 256, kMinBlocks = 2, BK = 32, LD = BM,
                       kStages = 3;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kThreads = 128, kMinBlocks = 3, BK = 32, LD = BM + 8,
                       kStages = 4;
};

template <typename T>
struct Stage {
  T a[Cfg<T>::BK][Cfg<T>::LD];  // rows of T, columns of the i-block
  T b[Cfg<T>::BK][Cfg<T>::LD];  // ... of the j-block (unused on the diagonal)
};

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int stages = Cfg<T>::kStages * static_cast<int>(sizeof(Stage<T>));
  return stages > kEpiBytes ? stages : kEpiBytes;
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

// pair p of the row-by-row enumeration of (ti <= tj): (0,0), (0,1), ...,
// (0,tiles-1), (1,1), ... (gram.tile_plan in Python gives the same order)
__device__ __forceinline__ void tile_pair(int p, int tiles, int& ti,
                                          int& tj) {
  ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  tj = ti + p;
}

// rows [k0, k0 + BK) and columns [c0, c0 + 128) of the slice into dst,
// zero past the edges
template <typename T, bool VEC, int BK = Cfg<T>::BK, int LD = Cfg<T>::LD>
__device__ __forceinline__ void load_block(T (&dst)[BK][LD],
                                           const T* __restrict__ ts, int k0,
                                           int c0, int r, int c) {
  constexpr int E = VEC ? 16 / sizeof(T) : 1;  // elements per copy
  constexpr int PER_ROW = BM / E;
#pragma unroll
  for (int e = threadIdx.x; e < BK * PER_ROW; e += Cfg<T>::kThreads) {
    const int row = e / PER_ROW, col = (e % PER_ROW) * E;
    const int k = k0 + row, j = c0 + col;
    // with VEC, c is a multiple of E: a chunk is wholly in or out
    const bool ok = k < r && j < c;
    const T* src = ok ? ts + static_cast<size_t>(k) * c + j : ts;
    if constexpr (VEC)
      ptx::cp_async16(&dst[row][col], src, ok ? 16 : 0);
    else if constexpr (sizeof(T) == 4)
      ptx::cp_async4(&dst[row][col], src, ok ? 4 : 0);
    else  // no 2-byte cp.async: a plain load
      dst[row][col] = ok ? *src : __float2bfloat16_rn(0.f);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(Stage<T>& st,
                                           const T* __restrict__ ts, int k0,
                                           int i0, int j0, bool diag, int r,
                                           int c) {
  load_block<T, VEC>(st.a, ts, k0, i0, r, c);
  if (!diag) load_block<T, VEC>(st.b, ts, k0, j0, r, c);
}

// fp32: thread (ty, tx) owns rows ty*4 + {0..3}, 64 + ty*4 + {0..3} and the
// same pattern of columns with tx
struct AccF32 {
  float v[TM][TM];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TM; ++b) v[a][b] = 0.f;
  }
  __device__ __forceinline__ void step(const Stage<float>& st, bool diag) {
    const int tx = threadIdx.x % (BM / TM), ty = threadIdx.x / (BM / TM);
    const auto& bs = diag ? st.a : st.b;
#pragma unroll
    for (int k = 0; k < Cfg<float>::BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&st.a[k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&st.a[k][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[k][BM / 2 + tx * 4]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TM; ++b) v[a][b] = fmaf(av[a], bv[b], v[a][b]);
    }
  }
  __device__ __forceinline__ void to_tile(float (*tile)[kPitch]) const {
    const int tx = threadIdx.x % (BM / TM), ty = threadIdx.x / (BM / TM);
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TM; ++b)
        tile[a < 4 ? ty * 4 + a : BM / 2 + ty * 4 + a - 4]
            [b < 4 ? tx * 4 + b : BM / 2 + tx * 4 + b - 4] = v[a][b];
  }
};

// bf16: warp w owns rows 64 (w / WN) + [0, 64) and columns 8 kNT (w % WN)
// + [0, 8 kNT) (WN = 2): four m16 tiles by kNT n8 tiles of mma fragments
struct AccBF16 {
  static constexpr int WN = BM / (8 * kNT);
  float v[4][kNT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[m][n][q] = 0.f;
  }
  __device__ __forceinline__ void step(const Stage<__nv_bfloat16>& st,
                                       bool diag) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int m0 = (w / WN) * 64, n0 = (w % WN) * 8 * kNT;
    const auto& bs = diag ? st.a : st.b;
#pragma unroll
    for (int kk = 0; kk < Cfg<__nv_bfloat16>::BK; kk += 16) {
      // B (k x n) from b[k][n]: matrix i is k + 8 (i & 1), n + 8 (i >> 1)
      uint32_t bf[kNT / 2][4];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        ptx::ldmatrix_x4_trans(
            bf[np], &bs[kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                       [n0 + 16 * np + (lane >> 4) * 8]);
      // A (m x k) from a[k][m], one m16 tile at a time: matrix i of x4 is
      // k + 8 (i >> 1), m + 8 (i & 1)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ptx::ldmatrix_x4_trans(
            af, &st.a[kk + (lane & 7) + (lane >> 4) * 8]
                     [m0 + 16 * mt + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          ptx::mma_bf16(v[mt][nt], af, bf[nt >> 1][(nt & 1) * 2],
                        bf[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
  }
  __device__ __forceinline__ void to_tile(float (*tile)[kPitch]) const {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int m0 = (w / WN) * 64, n0 = (w % WN) * 8 * kNT;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tile[m0 + 16 * mt + g + (q >> 1) * 8][n0 + 8 * nt + 2 * t + (q & 1)] =
              v[mt][nt][q];
  }
};

template <typename Tin, typename Tout, bool VEC>
__global__ void __launch_bounds__(Cfg<Tin>::kThreads, Cfg<Tin>::kMinBlocks)
gram_kernel(const Tin* __restrict__ t, Tout* __restrict__ out, int n, int r,
            int c, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<Tin>* st = reinterpret_cast<Stage<Tin>*>(smem);
  float(*tile)[kPitch] = reinterpret_cast<float(*)[kPitch]>(smem);
  using Acc = typename std::conditional<sizeof(Tin) == 4, AccF32,
                                        AccBF16>::type;
  constexpr int BK = Cfg<Tin>::BK, kStages = Cfg<Tin>::kStages;

  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
  const int i0 = ti * BM, j0 = tj * BM;
  const bool diag = ti == tj;
  const int nk = (r + BK - 1) / BK;

  for (int g = blockIdx.y; g < n; g += gridDim.y) {
    const Tin* ts = t + static_cast<size_t>(g) * r * c;
    Acc acc;
    acc.zero();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_stage<Tin, VEC>(st[s], ts, s * BK, i0, j0, diag, r, c);
      ptx::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      ptx::cp_async_wait<kStages - 2>();  // stage kt has landed
      __syncthreads();  // ... for every thread; stage kt - 1 is consumed
      const int pf = kt + kStages - 1;
      if (pf < nk)
        load_stage<Tin, VEC>(st[pf % kStages], ts, pf * BK, i0, j0, diag, r,
                             c);
      ptx::cp_async_commit();
      acc.step(st[kt % kStages], diag);
    }
    ptx::cp_async_wait<0>();
    __syncthreads();  // the stages are free: the epilogue tile reuses them
    acc.to_tile(tile);
    __syncthreads();

    // C[i0 + x][j0 + y] row by row, then the mirror C[j0 + y][i0 + x] row
    // by row: a warp stores 32 consecutive entries either way, and reads
    // them from the tile without bank conflicts (odd pitch)
    Tout* os = out + static_cast<size_t>(g) * c * c;
    const int ni = min(BM, c - i0), nj = min(BM, c - j0);
    const int lo = threadIdx.x % BM, hi = threadIdx.x / BM;
    constexpr int kStep = Cfg<Tin>::kThreads / BM;
    if (lo < nj)
      for (int x = hi; x < ni; x += kStep)
        os[static_cast<size_t>(i0 + x) * c + j0 + lo] =
            from_f<Tout>(tile[x][lo]);
    if (!diag && lo < ni)
      for (int y = hi; y < nj; y += kStep)
        os[static_cast<size_t>(j0 + y) * c + i0 + lo] =
            from_f<Tout>(tile[lo][y]);
    __syncthreads();  // the tile is read before the next slice's loads
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* t, void* out, int n, int r, int c,
                   cudaStream_t stream) {
  if (n < 0 || r < 0 || c < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int tiles = (c + BM - 1) / BM;
  const dim3 grid(tiles * (tiles + 1) / 2, n < 65535 ? n : 65535);
  const bool vec = (static_cast<size_t>(c) * sizeof(Tin)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(t) % 16 == 0;
  constexpr int smem = smem_bytes<Tin>();
  auto go = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, Cfg<Tin>::kThreads, smem, stream>>>(
        static_cast<const Tin*>(t), static_cast<Tout*>(out), n, r, c, tiles);
    return cudaGetLastError();
  };
  return vec ? go(gram_kernel<Tin, Tout, true>)
             : go(gram_kernel<Tin, Tout, false>);
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

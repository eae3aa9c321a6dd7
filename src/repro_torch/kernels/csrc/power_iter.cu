// Fused matrix-free power iteration for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/power_iter.py:_power_kernel (the Pallas TPU
// kernel behind power_iterate, power_iterate_chunk and power_matvec).
//
// What it computes, per slice T (r x c, fp32 or bf16) and start v0 (c, fp32):
//   n_upd sweeps of   tv = T round(v)          (fp32 sums)
//                     w  = T^T round(tv)       (fp32 sums)
//                     v  = w / (||w|| + 1e-30) (when `normalize`)
// where round() rounds to T's dtype, exactly where the Pallas body does
// (v before T v, tv before T^T tv).  `emit_gate` also writes, from the last
// sweep and before normalizing, lam = v.w and resid = ||w - lam v||.
// `lambda_pass` adds one trailing pass that writes lam = ||T round(v)||^2.
// `normalize == 0` is power_matvec: one sweep, the raw w is written out.
//
// What bounds it on this card: device-memory bytes.  Each sweep reads the
// whole slice once (b*r*c*bytes per sweep over all slices) and does
// 4*r*c flops per slice on it, about 1 flop per byte in fp32 and 2 in
// bf16, far below the H100's ~20 (fp32 CUDA cores) flops per byte.  The
// least time is b*r*c*bytes*sweeps at 3.35 TB/s.
//
// What the design does about it: one CTA per slice loops over the sweeps
// and over row tiles of its slice inside the block, so a whole gate chunk
// is one launch and no sync between blocks is ever needed (the TPU grid's
// sequential (sweep, r_tile) axes become loops).  v and w (c floats each)
// live in shared memory for the whole chunk; each tile_rows x c row tile
// is staged in shared memory once per sweep, then both contractions
// (tv = tile round(v), w += tile^T round(tv)) read it from there, so T is
// read from device memory exactly once per sweep.  Tiles are sized to
// ~48 KB so several CTAs share an SM and one CTA's loads overlap another's
// arithmetic.  The ragged last tile is bounded by a row count, not padded.
// Reductions run in a fixed order, so results are deterministic.  The
// block_r hint of the reference is not used: the tile height follows from
// c and the shared-memory budget.  Not yet used: TMA, cp.async pipelining,
// 16-byte loads (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 48 * 1024;  // budget of one staged row tile
constexpr int kMaxSmem = 232448;       // per-block dynamic shared memory cap

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum over the block; every thread gets the same result.  `red` holds
// kWarps floats; the leading sync keeps a previous call's readers safe.
__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < kWarps; ++i) s += red[i];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
power_kernel(const T* __restrict__ t, const float* __restrict__ v0,
             float* __restrict__ v_out, float* __restrict__ lam_out,
             float* __restrict__ resid_out, float* __restrict__ w_out, int r,
             int c, int tile_rows, int n_upd, int lambda_pass, int emit_gate,
             int normalize) {
  extern __shared__ float smem[];
  float* v = smem;                 // c
  float* w = v + c;                // c
  float* tv = w + c;               // tile_rows
  float* red = tv + tile_rows;     // kWarps
  T* tile = reinterpret_cast<T*>(red + kWarps);  // tile_rows * c

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t slice = blockIdx.x;
  const T* ts = t + slice * static_cast<size_t>(r) * c;

  for (int k = tid; k < c; k += kThreads) v[k] = v0[slice * c + k];
  float lam = 0.f, resid = 0.f;

  const int n_steps = n_upd + (lambda_pass ? 1 : 0);
  for (int it = 0; it < n_steps; ++it) {
    const bool update = it < n_upd;
    for (int k = tid; k < c; k += kThreads) w[k] = 0.f;
    float lam_acc = 0.f;  // lambda pass, thread 0 only
    for (int r0 = 0; r0 < r; r0 += tile_rows) {
      const int rows = min(tile_rows, r - r0);
      const int n = rows * c;
      const T* src = ts + static_cast<size_t>(r0) * c;
      __syncthreads();  // previous tile fully consumed; v and w visible
#pragma unroll 4
      for (int e = tid; e < n; e += kThreads) tile[e] = src[e];
      __syncthreads();
      // tv[row] = tile[row] . round(v): one warp per row
      for (int row = warp; row < rows; row += kWarps) {
        const T* tr = tile + static_cast<size_t>(row) * c;
        float s = 0.f;
        for (int k = lane; k < c; k += 32) s += round_to<T>(v[k]) * to_f(tr[k]);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) tv[row] = s;
      }
      __syncthreads();
      if (update) {
        // w += tile^T round(tv): each thread owns columns k, k+256, ...
        for (int k = tid; k < c; k += kThreads) {
          float s = 0.f;
          for (int row = 0; row < rows; ++row)
            s += round_to<T>(tv[row]) * to_f(tile[static_cast<size_t>(row) * c + k]);
          w[k] += s;
        }
      } else if (tid == 0) {
        for (int row = 0; row < rows; ++row) lam_acc += tv[row] * tv[row];
      }
    }
    __syncthreads();  // w complete
    if (!update) {
      lam = lam_acc;
      break;
    }
    if (emit_gate && it == n_upd - 1) {
      float p = 0.f;
      for (int k = tid; k < c; k += kThreads) p += w[k] * v[k];
      lam = block_sum(p, red);
      float q = 0.f;
      for (int k = tid; k < c; k += kThreads) {
        const float d = w[k] - lam * v[k];
        q += d * d;
      }
      resid = sqrtf(block_sum(q, red));
    }
    if (normalize) {
      float q = 0.f;
      for (int k = tid; k < c; k += kThreads) q += w[k] * w[k];
      const float nrm = sqrtf(block_sum(q, red)) + 1e-30f;
      for (int k = tid; k < c; k += kThreads) v[k] = w[k] / nrm;
    }
  }
  __syncthreads();
  for (int k = tid; k < c; k += kThreads) {
    v_out[slice * c + k] = v[k];
    if (w_out) w_out[slice * c + k] = w[k];
  }
  if (tid == 0) {
    lam_out[slice] = lam;
    resid_out[slice] = resid;
  }
}

template <typename T>
cudaError_t launch(const void* t, const void* v0, void* v_out, void* lam,
                   void* resid, void* w_out, int b, int r, int c, int n_upd,
                   int lambda_pass, int emit_gate, int normalize,
                   cudaStream_t stream) {
  const long row_bytes = static_cast<long>(c) * sizeof(T);
  int tile_rows = static_cast<int>(kTileBytes / row_bytes);
  tile_rows = tile_rows < 1 ? 1 : (tile_rows > r ? r : tile_rows);
  const long smem = (2L * c + tile_rows + kWarps) * sizeof(float) +
                    tile_rows * row_bytes;
  if (b < 0 || r < 1 || c < 1 || n_upd < 0 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        power_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  power_kernel<T><<<b, kThreads, smem, stream>>>(
      static_cast<const T*>(t), static_cast<const float*>(v0),
      static_cast<float*>(v_out), static_cast<float*>(lam),
      static_cast<float*>(resid), static_cast<float*>(w_out), r, c, tile_rows,
      n_upd, lambda_pass, emit_gate, normalize);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers to
// contiguous tensors: t (b, r, c); v0, v_out, w_out (b, c); lam, resid (b,).
// w_out may be NULL.  Returns a cudaError_t (0 = launched).
extern "C" int msc_power_iter(int device, int dtype, const void* t,
                              const void* v0, void* v_out, void* lam,
                              void* resid, void* w_out, int b, int r, int c,
                              int n_upd, int lambda_pass, int emit_gate,
                              int normalize, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(t, v0, v_out, lam, resid, w_out, b, r, c, n_upd,
                         lambda_pass, emit_gate, normalize, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(t, v0, v_out, lam, resid, w_out, b, r, c,
                                 n_upd, lambda_pass, emit_gate, normalize, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* msc_power_iter_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

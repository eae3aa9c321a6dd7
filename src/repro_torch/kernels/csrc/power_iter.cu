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
// Sums run in a fixed order, so two calls give the same bits (the trim and
// the max-gap extraction read d).
//
// What bounds it on this card: device-memory bytes.  A slice at
// c = r = 1000 is 4 MB in fp32 (2 MB in bf16), far more than one SM holds,
// so each sweep reads the whole slice from device memory once: the
// streaming bound is b*r*c*bytes per sweep at 3.35 TB/s (7.16 / 3.58 ms per
// 6-sweep chunk at 1000^3 in fp32 / bf16).  Each sweep does 4*r*c flops
// per slice, about 1 flop per byte in fp32 and 2 in bf16, far below the
// ~20 flops per byte where the fp32 CUDA cores would be the limit.
//
// What the design does about it: one CTA per slice loops over the sweeps
// inside the block, so a whole gate chunk is one launch and no sync
// between blocks is ever needed (the TPU grid's sequential (sweep, r_tile)
// axes become loops).  Two routes, picked by the wrapper
// (power_iter.route(c, dtype)); `launches` counts either.
// - The streaming route (power_stream_kernel), where a row's pitch c * elt
//   is a multiple of 16 bytes and c <= 2048 (v and w of c/32 floats each
//   per lane fit in registers; fp32 c * elt <= 8 KB, which covers the
//   paper's largest m = 1400).  4 warps per CTA; warp q takes rows
//   k = q, q + 4, ..., and lane l owns the same 16-byte chunks l, l + 32,
//   ... of every row, so round(v) sits in registers, rounded once per
//   sweep.  One pass per row touches each element of T once per sweep:
//   one 16-byte load, then dot(row, round(v)) in fp32 and a 5-step
//   butterfly give tv_k (the same bits in every lane), tv_k is rounded
//   once, and round(tv_k) * row is added into the warp's partial w, held
//   in registers for the same columns.  At the end of a sweep the four
//   partials are added in warp order through shared memory, then lam,
//   resid, ||w|| and v follow as in the general route.  The lambda pass
//   sums tv^2 per warp, then in warp order.  Rows reach registers by one
//   of two variants, template flag RING: straight from device memory
//   (ld.global.nc, 16 bytes a lane, two rows in flight per warp; c * elt
//   <= 4 KB) or through a warp-private ring of 3 rows in shared memory
//   filled by cp.async (two rows in flight, no registers held for them).
//   The wrapper's route() picks one by measurement (PERF.md).  Templated on
//   the 16-byte chunks per lane (NCH = 1, 2, 4, 8, 16).  At least two CTAs
//   stay resident per SM, so one CTA's end-of-sweep reduction overlaps
//   another's streaming.
// - The general route (power_kernel): rows whose pitch is not a multiple
//   of 16 bytes, a base that is not 16-byte aligned, or c beyond the
//   register budget.  v and w live in shared memory; each tile_rows x c row
//   tile (~48 KB) is staged in shared memory once per sweep with
//   one-element loads, then both contractions read it from there.  The
//   ragged last tile is bounded by a row count, not padded.
// The block_r hint of the reference is not used.  The next step, not
// taken here: T read once per chunk, a slice resident across sweeps in the
// shared memory of a thread-block cluster (~16 SMs for a 2 MB bf16 slice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 48 * 1024;  // budget of one staged row tile
constexpr int kMaxSmem = 232448;       // per-block dynamic shared memory cap

// the streaming route (power_iter.py mirrors these)
constexpr int kSWarps = 4;  // power_iter.WARPS
constexpr int kSThreads = 32 * kSWarps;
constexpr int kRing = 3;            // rows per warp in the shared-memory ring
constexpr int kMaxCols = 2048;      // power_iter.MAX_COLS
constexpr int kDirectBytes = 4096;  // power_iter.DIRECT_BYTES: c * elt

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

// Sum over the block of NW warps; every thread gets the same result.
// `red` holds NW floats; the leading sync keeps a previous call's readers
// safe.
template <int NW = kWarps>
__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < NW; ++i) s += red[i];
  return s;
}

// ---- the general route ----

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


// ---- the streaming route ----

// the compiler keeps shared-memory accesses on their side of this line
// (cp.async and its wait carry no memory clobber in ptx.cuh)
__device__ __forceinline__ void compiler_fence() {
  asm volatile("" ::: "memory");
}

// the elements of one 16-byte chunk as fp32 (exact for bf16; element 0 is
// the low half of the first word)
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

template <typename T, int NCH, bool RING>
__global__ void __launch_bounds__(kSThreads, 2)
power_stream_kernel(const T* __restrict__ t, const float* __restrict__ v0,
                    float* __restrict__ v_out, float* __restrict__ lam_out,
                    float* __restrict__ resid_out, float* __restrict__ w_out,
                    int r, int c, int n_upd, int lambda_pass, int emit_gate,
                    int normalize) {
  constexpr int E = 16 / sizeof(T);  // elements per chunk
  extern __shared__ __align__(16) float smem[];
  float* v = smem;         // c (a multiple of 4)
  float* red = v + c;      // kSWarps
  float* wred = red + 4;   // kSWarps x c partials; with RING it aliases
  T* ring = reinterpret_cast<T*>(wred);  // kSWarps x kRing rows of c

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t slice = blockIdx.x;
  const T* ts = t + slice * static_cast<size_t>(r) * c;
  const int nq = c / E;  // chunks per row

  for (int k = tid; k < c; k += kSThreads) v[k] = v0[slice * c + k];
  float lam = 0.f, resid = 0.f;

  const int n_steps = n_upd + (lambda_pass ? 1 : 0);
  for (int it = 0; it < n_steps; ++it) {
    const bool update = it < n_upd;
    __syncthreads();  // v complete; the last sweep's partials consumed
    float vr[NCH][E], w[NCH][E];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int q = lane + 32 * j;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        vr[j][e] = q < nq ? round_to<T>(v[q * E + e]) : 0.f;
        w[j][e] = 0.f;
      }
    }
    float lam_w = 0.f;  // lambda pass: this warp's sum of tv^2
    auto process = [&](const uint4(&row)[NCH]) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        if (lane + 32 * j < nq) {
          float f[E];
          unpack(row[j], f);
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(f[e], vr[j][e], s);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (update) {
        const float rt = round_to<T>(s);
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          if (lane + 32 * j < nq) {
            float f[E];
            unpack(row[j], f);
#pragma unroll
            for (int e = 0; e < E; ++e) w[j][e] = fmaf(rt, f[e], w[j][e]);
          }
        }
      } else {
        lam_w += s * s;
      }
    };

    if constexpr (!RING) {
      // straight into registers: rows k and k + 4 in flight
      uint4 ra[NCH], rb[NCH];
      auto fetch = [&](uint4(&dst)[NCH], int k) {
        if (k >= r) return;
        const uint4* row =
            reinterpret_cast<const uint4*>(ts + static_cast<size_t>(k) * c);
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int q = lane + 32 * j;
          dst[j] = q < nq ? __ldg(row + q) : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      fetch(ra, warp);
      fetch(rb, warp + kSWarps);
      for (int k = warp; k < r; k += 2 * kSWarps) {
        process(ra);
        fetch(ra, k + 2 * kSWarps);
        if (k + kSWarps < r) process(rb);
        fetch(rb, k + 3 * kSWarps);
      }
    } else {
      // through this warp's ring of kRing rows: each lane copies and reads
      // back only its own chunks, so the lane's own wait orders them
      T* mine = ring + static_cast<size_t>(warp) * kRing * c;
      auto prefetch = [&](int slot, int k) {
        if (k < r) {
          const T* row = ts + static_cast<size_t>(k) * c;
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            const int q = lane + 32 * j;
            if (q < nq)
              ptx::cp_async16(mine + slot * c + q * E, row + q * E, 16);
          }
        }
        ptx::cp_async_commit();  // an empty group past the last row
      };
#pragma unroll
      for (int s = 0; s < kRing - 1; ++s) prefetch(s, warp + s * kSWarps);
      int slot = 0;
      for (int k = warp; k < r; k += kSWarps) {
        ptx::cp_async_wait<kRing - 2>();  // row k has landed
        compiler_fence();
        uint4 row[NCH];
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int q = lane + 32 * j;
          row[j] = q < nq ? *reinterpret_cast<const uint4*>(mine + slot * c +
                                                            q * E)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
        compiler_fence();
        // the slot read one row ago takes row k + (kRing - 1) * 4
        prefetch(slot == 0 ? kRing - 1 : slot - 1,
                 k + (kRing - 1) * kSWarps);
        process(row);
        slot = slot + 1 == kRing ? 0 : slot + 1;
      }
      ptx::cp_async_wait<0>();
    }

    if (!update) {
      if (lane == 0) red[warp] = lam_w;
      __syncthreads();
      lam = 0.f;
      for (int i = 0; i < kSWarps; ++i) lam += red[i];
      break;
    }
    if constexpr (RING) __syncthreads();  // every warp is done with the ring
    float* mine = wred + static_cast<size_t>(warp) * c;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int q = lane + 32 * j;
      if (q < nq) {
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(mine + q * E + e) =
              make_float4(w[j][e], w[j][e + 1], w[j][e + 2], w[j][e + 3]);
      }
    }
    __syncthreads();
    // the partials in warp order; each thread then reads only its own
    // columns k = tid, tid + 128, ... until the next sweep's barrier
    for (int k = tid; k < c; k += kSThreads) {
      float s = wred[k];
#pragma unroll
      for (int i = 1; i < kSWarps; ++i) s += wred[static_cast<size_t>(i) * c + k];
      wred[k] = s;
      if (w_out && it == n_upd - 1) w_out[slice * c + k] = s;
    }
    const float* wf = wred;
    if (emit_gate && it == n_upd - 1) {
      float p = 0.f;
      for (int k = tid; k < c; k += kSThreads) p += wf[k] * v[k];
      lam = block_sum<kSWarps>(p, red);
      float q = 0.f;
      for (int k = tid; k < c; k += kSThreads) {
        const float d = wf[k] - lam * v[k];
        q += d * d;
      }
      resid = sqrtf(block_sum<kSWarps>(q, red));
    }
    if (normalize) {
      float q = 0.f;
      for (int k = tid; k < c; k += kSThreads) q += wf[k] * wf[k];
      const float nrm = sqrtf(block_sum<kSWarps>(q, red)) + 1e-30f;
      for (int k = tid; k < c; k += kSThreads) v[k] = wf[k] / nrm;
    }
  }
  __syncthreads();
  for (int k = tid; k < c; k += kSThreads) v_out[slice * c + k] = v[k];
  if (tid == 0) {
    lam_out[slice] = lam;
    resid_out[slice] = resid;
  }
}

// the chunks per lane a row of c elements needs: 1, 2, 4, 8 or 16
template <typename T>
int chunks_per_lane(int c) {
  const int per_lane = (c * static_cast<int>(sizeof(T)) / 16 + 31) / 32;
  int nch = 1;
  while (nch < per_lane) nch *= 2;
  return nch;
}

// dynamic shared memory of the streaming kernel: v, the warp sums, and
// the warps' partial w (with RING, the larger of them and the row ring)
template <typename T, bool RING>
size_t stream_smem(int c) {
  const size_t parts = static_cast<size_t>(kSWarps) * c * sizeof(float);
  const size_t rows = static_cast<size_t>(kSWarps) * kRing * c * sizeof(T);
  return (c + 4) * sizeof(float) +
         (RING ? (rows > parts ? rows : parts) : parts);
}

// f(kernel, shared memory bytes) for the streaming kernel of this route
// (1 = straight into registers, 2 = through the ring) and c; refuses rows
// whose pitch is not a multiple of 16 bytes, c > kMaxCols, and route 1
// with c * elt > kDirectBytes
template <typename T, typename F>
cudaError_t with_stream_kernel(int route, int c, F&& f) {
  const int elt = static_cast<int>(sizeof(T));
  if (c < 1 || (c * elt) % 16 != 0 || c > kMaxCols ||
      !(route == 2 || (route == 1 && c * elt <= kDirectBytes)))
    return cudaErrorInvalidValue;
#define MSC_STREAM(NCH, RING) \
  return f(power_stream_kernel<T, NCH, RING>, stream_smem<T, RING>(c))
  const int nch = chunks_per_lane<T>(c);
  if (route == 1) {
    switch (nch) {
      case 1: MSC_STREAM(1, false);
      case 2: MSC_STREAM(2, false);
      case 4: MSC_STREAM(4, false);
      case 8: MSC_STREAM(8, false);
    }
  } else {
    switch (nch) {
      case 1: MSC_STREAM(1, true);
      case 2: MSC_STREAM(2, true);
      case 4: MSC_STREAM(4, true);
      case 8: MSC_STREAM(8, true);
      case 16:
        if constexpr (sizeof(T) == 4) MSC_STREAM(16, true);
        break;
    }
  }
#undef MSC_STREAM
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_stream(int route, const void* t, const void* v0,
                          void* v_out, void* lam, void* resid, void* w_out,
                          int b, int r, int c, int n_upd, int lambda_pass,
                          int emit_gate, int normalize, cudaStream_t stream) {
  if (b < 0 || r < 1 || n_upd < 0 || reinterpret_cast<uintptr_t>(t) % 16)
    return cudaErrorInvalidValue;
  return with_stream_kernel<T>(route, c, [&](auto kernel, size_t smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess || b == 0) return e;
    kernel<<<b, kSThreads, smem, stream>>>(
        static_cast<const T*>(t), static_cast<const float*>(v0),
        static_cast<float*>(v_out), static_cast<float*>(lam),
        static_cast<float*>(resid), static_cast<float*>(w_out), r, c, n_upd,
        lambda_pass, emit_gate, normalize);
    return cudaGetLastError();
  });
}

// CTAs of the streaming kernel resident on one SM at c
template <typename T>
cudaError_t stream_ctas_per_sm(int route, int c, int* out) {
  return with_stream_kernel<T>(route, c, [&](auto kernel, size_t smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                         kSThreads, smem);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = general, 1 = streaming
// straight into registers, 2 = streaming through the shared-memory ring
// (power_iter.route() picks; a streaming route refuses rows whose pitch is
// not a multiple of 16 bytes or c > 2048, and route 1 also c * elt > 4096).
// Pointers are device pointers to contiguous tensors: t (b, r, c); v0,
// v_out, w_out (b, c); lam, resid (b,).  w_out may be NULL.  Returns a
// cudaError_t (0 = launched).
extern "C" int msc_power_iter(int device, int dtype, int route, const void* t,
                              const void* v0, void* v_out, void* lam,
                              void* resid, void* w_out, int b, int r, int c,
                              int n_upd, int lambda_pass, int emit_gate,
                              int normalize, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 || route == 2) {
    if (dtype == 0)
      return launch_stream<float>(route, t, v0, v_out, lam, resid, w_out, b,
                                  r, c, n_upd, lambda_pass, emit_gate,
                                  normalize, s);
    if (dtype == 1)
      return launch_stream<__nv_bfloat16>(route, t, v0, v_out, lam, resid,
                                          w_out, b, r, c, n_upd, lambda_pass,
                                          emit_gate, normalize, s);
    return cudaErrorInvalidValue;
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(t, v0, v_out, lam, resid, w_out, b, r, c, n_upd,
                         lambda_pass, emit_gate, normalize, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(t, v0, v_out, lam, resid, w_out, b, r, c,
                                 n_upd, lambda_pass, emit_gate, normalize, s);
  return cudaErrorInvalidValue;
}

// the CTAs of the streaming route (1 or 2) resident per SM for rows of c
// elements of dtype, into *out (how many waves b slices take)
extern "C" int msc_power_iter_ctas_per_sm(int device, int dtype, int route,
                                          int c, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (dtype == 0) return stream_ctas_per_sm<float>(route, c, out);
  if (dtype == 1) return stream_ctas_per_sm<__nv_bfloat16>(route, c, out);
  return cudaErrorInvalidValue;
}

extern "C" const char* msc_power_iter_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

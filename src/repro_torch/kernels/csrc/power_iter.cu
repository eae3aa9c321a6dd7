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
// c = r = 1000 is 4 MB in fp32 (2 MB in bf16), far more than one SM holds.
// Read once per sweep, the bound is b*r*c*bytes per sweep at 3.35 TB/s
// (7.16 / 3.58 ms per 6-sweep chunk at 1000^3 in fp32 / bf16); read once
// per launch, 1.19 / 0.60 ms.  Each sweep does 4*r*c flops per slice,
// about 1 flop per byte in fp32 and 2 in bf16, far below the ~20 flops
// per byte where the fp32 CUDA cores would be the limit.
//
// What the design does about it: the sweeps of a launch loop inside the
// kernel, so a whole gate chunk is one launch (the TPU grid's sequential
// (sweep, r_tile) axes become loops).  Three routes, picked by the wrapper
// (power_iter.route(c, dtype, k, r): the dtype, the rows r and the passes
// over T in the launch k, all seen in the call); `launches` counts any.
// - The streaming route (power_stream_kernel), where a row's pitch c * elt
//   is a multiple of 16 bytes and c <= 2048 (v and w of c/32 floats each
//   per lane fit in registers; fp32 c * elt <= 8 KB, which covers the
//   paper's largest m = 1400).  One CTA per slice, no sync between
//   blocks.  4 warps per CTA; warp q takes rows k = q, q + 4, ..., and
//   lane l owns the same 16-byte chunks l, l + 32, ... of every row, so
//   round(v) sits in registers, rounded once per sweep.  One pass per row
//   touches each element of T once per sweep: one 16-byte load, then
//   dot(row, round(v)) in fp32 and a 5-step butterfly give tv_k (the same
//   bits in every lane), tv_k is rounded once, and round(tv_k) * row is
//   added into the warp's partial w, held in registers for the same
//   columns.  At the end of a sweep the four partials are added in warp
//   order through shared memory, then lam, resid, ||w|| and v follow as in
//   the general route.  The lambda pass sums tv^2 per warp, then in warp
//   order.  Rows reach registers by one of two variants, template flag
//   RING: straight from device memory (ld.global.nc, 16 bytes a lane, two
//   rows in flight per warp; c * elt <= 4 KB) or through a warp-private
//   ring of 3 rows in shared memory filled by cp.async (two rows in
//   flight, no registers held for them).  route() picks one by
//   measurement (PERF.md).  Templated on the 16-byte chunks per lane (NCH
//   = 1, 2, 4, 8, 16).  At least two CTAs stay resident per SM, so one
//   CTA's end-of-sweep reduction overlaps another's streaming.  Each sweep
//   reads the whole slice from device memory: 95% of that bound at 1000^3
//   fp32, and the only room left is reuse of T across a chunk's sweeps.
// - The resident route (power_resident_kernel), on the same rows, for a
//   launch of k >= 2 passes over T: T read from device memory once per
//   launch.  One thread-block cluster of g CTAs (a power of two up to 16,
//   beyond the portable 8 with the non-portable attribute) per slice, the
//   smallest g whose bands of rows fit the CTAs' shared memory (g = 16 at
//   1000^2 fp32: 52 of each 63-row band held, the rest re-read each pass
//   from L2; g = 4 at 400^2).  Persistent: the grid is the clusters
//   resident at once (cudaOccupancyMaxActiveClusters), each walking over
//   the slices, launched with cudaLaunchKernelEx (graph capture takes it).
//   On a slice's first pass the TMA brings the band into shared memory
//   (bulk copies of whole rows completing on mbarriers, a warp starting
//   on its rows as they land); during its last pass the next slice's
//   band is copied in, and the one after that brought into L2.  Each
//   pass: 8 warps take the band's rows as the streaming route does (two
//   rows at a time, round(v) and the warp's partial w in registers); the
//   warps' partials add in a fixed order through shared memory; each CTA
//   sends each column range of its partial to the CTA that owns it
//   (distributed shared memory), a cluster barrier, each CTA sums its
//   columns over the cluster in rank order and sends the sums and their
//   share of ||w||^2 to every CTA, a second cluster barrier, and every CTA
//   then holds the whole w, lam, resid and the new v.  Every sum runs in
//   a fixed order, so two calls give the same bits (not the streaming
//   route's: d and lam differ from it at rounding level).  What bounds it
//   is latency, not bytes: a pass is ~6.5 us a slice, of which ~3 us the
//   rows and the rest the two barriers and the exchanges (PERF.md).
// - The general route (power_kernel): rows whose pitch is not a multiple
//   of 16 bytes, a base that is not 16-byte aligned, or c beyond the
//   register budget.  v and w live in shared memory; each tile_rows x c row
//   tile (~48 KB) is staged in shared memory once per sweep with
//   one-element loads, then both contractions read it from there.  The
//   ragged last tile is bounded by a row count, not padded.
// The block_r hint of the reference is not used.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ptx.cuh"

namespace cg = cooperative_groups;

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

// the resident route (power_iter.py mirrors these)
constexpr int kRWarps = 8;  // power_iter.RESIDENT_WARPS
constexpr int kRThreads = 32 * kRWarps;

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


// ---- the resident route ----

// The resident kernel's shared memory before its rows: the barriers (8
// bytes each, padded to 16), then v, wp, wl, wg (c floats each), wr (c +
// 128 floats), red (kRWarps), norms (16) and the lambda-pass slot (4).
__host__ __device__ inline size_t resident_head(int c, int n_bars) {
  return (static_cast<size_t>(n_bars) * 8 + 15) / 16 * 16 +
         (5 * static_cast<size_t>(c) + 128 + kRWarps + 16 + 4) * sizeof(float);
}

// bytes after the last row that a lane's NCH chunks read past it
template <typename T>
__host__ __device__ inline size_t resident_tail(int c) {
  const int nq = c * static_cast<int>(sizeof(T)) / 16;
  int nch = 1;
  while (32 * nch < nq) nch *= 2;
  return static_cast<size_t>(32 * nch - nq) * 16;
}

// the columns each CTA of a cluster of g sums: c / g rounded up to 8, so
// a float4 never straddles two CTAs' columns
__host__ __device__ inline int resident_cols(int c, int g) {
  return ((c + g - 1) / g + 7) / 8 * 8;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kRThreads, 1)
power_resident_kernel(const T* __restrict__ t, const float* __restrict__ v0,
                      float* __restrict__ v_out, float* __restrict__ lam_out,
                      float* __restrict__ resid_out, int b, int r, int c,
                      int g_size, int band, int n_res, int per_bar,
                      int n_upd, int lambda_pass, int emit_gate) {
  constexpr int E = 16 / sizeof(T);  // elements per chunk
  // rows a warp takes at once, and rows past the shared-memory ones it
  // loads into registers before them: as many as registers hold beside
  // round(v) and the partial w (else the first is brought into L1)
  constexpr int kGroup = NCH <= 8 ? 2 : 1;
  constexpr int kFar = NCH <= 4 ? 2 : 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_bars = (n_res + per_bar - 1) / per_bar;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* v = reinterpret_cast<float*>(smem_raw + (n_bars * 8 + 15) / 16 * 16);
  float* wp = v + c;   // this CTA's partial w
  float* wl = wp + c;  // scratch of the warps' sum
  float* wg = wl + c;  // scratch of the warps' sum; then the whole w
  float* wr = wg + c;  // [g][cw]: the cluster's partials of this CTA's columns
  float* red = wr + c + 128;        // kRWarps
  float* norms = red + kRWarps;     // [g]: each CTA's share of ||w||^2
  float* lam_slot = norms + 16;     // this CTA's share of the lambda pass
  T* rows = reinterpret_cast<T*>(lam_slot + 4);  // n_res rows of c

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cluster_id = blockIdx.x / g_size;
  const int n_clusters = gridDim.x / g_size;
  const int row0 = rank * band;
  const int n_rows = max(0, min(band, r - row0));  // this CTA's band
  const int mine = min(n_rows, n_res);             // ... held in smem
  const int my_bars = (mine + per_bar - 1) / per_bar;
  const int cw = resident_cols(c, g_size);
  const int lo = min(c, rank * cw), hi = min(c, lo + cw);
  const int nq = c / E;  // chunks per row
  // this warp's first row past the shared-memory ones
  const int first_far = mine <= warp
                            ? warp
                            : warp + (mine - warp + kRWarps - 1) / kRWarps *
                                         kRWarps;

  for (int i = tid; i < my_bars; i += kRThreads) ptx::mbar_init(bars + i, 1);
  {  // past this CTA's rows: zeros, which no copy overwrites
    float* tail = reinterpret_cast<float*>(rows + static_cast<size_t>(mine) * c);
    const int n = static_cast<int>(((n_res - mine) * static_cast<size_t>(c) *
                                        sizeof(T) +
                                    resident_tail<T>(c)) /
                                   sizeof(float));
    for (int k = tid; k < n; k += kRThreads) tail[k] = 0.f;
  }
  ptx::fence_mbar_init();
  // every CTA of the cluster is running before any touches another's smem
  ptx::cluster_sync();

  // this CTA's rows of slice sl into shared memory (each copy completing
  // on its barrier), and its band of the slice after into L2
  auto load_band = [&](int sl) {
    if (warp != 0 || sl >= b) return;
    const T* src = t + (static_cast<size_t>(sl) * r + row0) * c;
    ptx::fence_proxy_async();  // after the reads of the rows it replaces
    for (int q = lane; q < my_bars; q += 32) {
      const int first = q * per_bar, n = min(per_bar, mine - first);
      const uint32_t bytes = static_cast<uint32_t>(n) * c * sizeof(T);
      ptx::mbar_expect_tx(bars + q, bytes);
      ptx::bulk_g2s(rows + static_cast<size_t>(first) * c,
                    src + static_cast<size_t>(first) * c, bytes, bars + q);
    }
    if (lane == 0 && sl + n_clusters < b && n_rows > 0)
      ptx::prefetch_l2(src + static_cast<size_t>(n_clusters) * r * c,
                       static_cast<uint32_t>(n_rows) * c * sizeof(T));
  };
  load_band(cluster_id);

  int visit = 0;  // slices this cluster has taken: the barriers' phase
  for (int s = cluster_id; s < b; s += n_clusters, ++visit) {
    const size_t slice = s;
    const T* ts = t + (slice * r + row0) * static_cast<size_t>(c);
    __syncthreads();  // the last slice's v written out
    for (int k = tid; k < c; k += kRThreads) v[k] = v0[slice * c + k];
    const uint32_t parity = visit & 1;
    float lam = 0.f, resid = 0.f;

    const int n_steps = n_upd + (lambda_pass ? 1 : 0);
    for (int it = 0; it < n_steps; ++it) {
      const bool update = it < n_upd;
      __syncthreads();  // v complete
      float vr[NCH][E], w[NCH][E];
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int q = lane + 32 * j;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 x = q < nq ? *reinterpret_cast<const float4*>(
                                        v + q * E + e)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          vr[j][e] = round_to<T>(x.x);
          vr[j][e + 1] = round_to<T>(x.y);
          vr[j][e + 2] = round_to<T>(x.z);
          vr[j][e + 3] = round_to<T>(x.w);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) w[j][e] = 0.f;
      }
      float lam_w = 0.f;  // lambda pass: this warp's sum of tv^2
      // this lane's share of row . round(v), in two chains; past the row
      // (q >= nq) round(v) is 0 and the row finite, so nothing is added
      auto dot = [&](const uint4(&row)[NCH]) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          float f[E];
          unpack(row[j], f);
#pragma unroll
          for (int e = 0; e < E; e += 2) {
            s0 = fmaf(f[e], vr[j][e], s0);
            s1 = fmaf(f[e + 1], vr[j][e + 1], s1);
          }
        }
        return s0 + s1;
      };
      // w += round(tv) row (w past the row is never read), or the lambda
      // pass's tv^2
      auto take = [&](float tv, const uint4(&row)[NCH]) {
        if (update) {
          const float rt = round_to<T>(tv);
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            float f[E];
            unpack(row[j], f);
#pragma unroll
            for (int e = 0; e < E; ++e) w[j][e] = fmaf(rt, f[e], w[j][e]);
          }
        } else {
          lam_w += tv * tv;
        }
      };
      auto landed = [&](int i) {  // on the first pass, row i's copy is in
        if (it == 0) ptx::mbar_wait(bars + i / per_bar, parity);
      };
      // row i < mine from smem, read on past its end into the next row or
      // the zeroed tail (finite either way)
      auto near = [&](uint4(&dst)[NCH], int i) {
        const uint4* row =
            reinterpret_cast<const uint4*>(rows + static_cast<size_t>(i) * c);
#pragma unroll
        for (int j = 0; j < NCH; ++j) dst[j] = row[lane + 32 * j];
      };
      auto far = [&](uint4(&dst)[NCH], int i) {  // row i >= mine, from L2
        const uint4* row =
            reinterpret_cast<const uint4*>(ts + static_cast<size_t>(i) * c);
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int q = lane + 32 * j;
          dst[j] = q < nq ? __ldg(row + q) : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      auto butterfly = [](float x) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        return x;
      };

      // warp q takes rows q, q + kRWarps, ... of the band, in that order:
      // kGroup rows of shared memory at a time, then the rows past them
      uint4 fr[kFar > 0 ? kFar : 1][NCH];
#pragma unroll
      for (int u = 0; u < kFar; ++u)
        if (first_far + u * kRWarps < n_rows) far(fr[u], first_far + u * kRWarps);
      if (kFar == 0 && first_far < n_rows) {
        const char* row =
            reinterpret_cast<const char*>(ts + static_cast<size_t>(first_far) * c);
        for (int o = 128 * lane; o < c * static_cast<int>(sizeof(T)); o += 32 * 128)
          ptx::prefetch_l1(row + o);
      }
      int i = warp;
      for (; i + (kGroup - 1) * kRWarps < mine; i += kGroup * kRWarps) {
        uint4 rr[kGroup][NCH];
        float sv[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) landed(i + u * kRWarps);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) near(rr[u], i + u * kRWarps);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) sv[u] = dot(rr[u]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
            sv[u] += __shfl_xor_sync(0xffffffffu, sv[u], o);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) take(sv[u], rr[u]);
      }
      for (; i < mine; i += kRWarps) {
        uint4 ra[NCH];
        landed(i);
        near(ra, i);
        take(butterfly(dot(ra)), ra);
      }
      int g = first_far;
#pragma unroll
      for (int u = 0; u < kFar; ++u, g += kRWarps)
        if (g < n_rows) take(butterfly(dot(fr[u])), fr[u]);
      for (; g < n_rows; g += kRWarps) {
        uint4 ra[NCH];
        far(ra, g);
        take(butterfly(dot(ra)), ra);
      }
      if (it == n_steps - 1) {  // this slice's rows are read: the next's
        __syncthreads();        // land during the rest of this pass
        load_band(s + n_clusters);
      }

      if (!update) {
        if (lane == 0) red[warp] = lam_w;
        __syncthreads();
        if (tid == 0) {
          float a = 0.f;
          for (int h = 0; h < kRWarps; ++h) a += red[h];
          *lam_slot = a;
        }
        ptx::cluster_sync();
        if (tid == 0) {
          float part[16];
#pragma unroll
          for (int h = 0; h < 16; ++h)
            part[h] = h < g_size ? *cluster.map_shared_rank(lam_slot, h) : 0.f;
#pragma unroll
          for (int h = 0; h < 16; ++h)
            if (h < g_size) lam += part[h];
        }
        break;
      }
      // the warps' partials: (w0 + w3) + w6 ... in wl, (w1 + w4) + w7 ...
      // in wg, (w2 + w5) ... in wp, then wp = (wl + wg) + wp; each lane
      // its own columns
      float* mine_w = warp % 3 == 0 ? wl : (warp % 3 == 1 ? wg : wp);
#pragma unroll 1
      for (int step = 0; 3 * step < kRWarps; ++step) {
        if (warp / 3 == step) {
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            const int q = lane + 32 * j;
            if (q < nq) {
#pragma unroll
              for (int e = 0; e < E; e += 4) {
                float4* d = reinterpret_cast<float4*>(mine_w + q * E + e);
                const float4 x =
                    make_float4(w[j][e], w[j][e + 1], w[j][e + 2], w[j][e + 3]);
                *d = step == 0 ? x : add4(*d, x);
              }
            }
          }
        }
        __syncthreads();
      }
      for (int k = 4 * tid; k < c; k += 4 * kRThreads) {
        float4* d = reinterpret_cast<float4*>(wp + k);
        *d = add4(add4(*reinterpret_cast<const float4*>(wl + k),
                       *reinterpret_cast<const float4*>(wg + k)),
                  *d);
      }
      __syncthreads();
      // each CTA's columns of the partial to the CTA that sums them
      for (int k = 4 * tid; k < c; k += 4 * kRThreads) {
        const int h = k / cw;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(wr, h) +
                                   rank * cw + (k - h * cw)) =
            *reinterpret_cast<const float4*>(wp + k);
      }
      ptx::cluster_sync();  // every partial has reached its columns' CTA
      // this CTA's columns summed over the cluster in rank order (by every
      // warp, each sending them to its own CTAs h = warp, warp + kRWarps,
      // ...), and warp 0 their share of ||w||^2 to every CTA
      const int n4 = (hi - lo) / 4;
      float sq = 0.f;
      for (int x = lane; x < n4; x += 32) {
        float4 part[16];
#pragma unroll
        for (int h = 0; h < 16; ++h)
          if (h < g_size)
            part[h] = *reinterpret_cast<const float4*>(wr + h * cw + 4 * x);
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 16; ++h)
          if (h < g_size) sum = add4(sum, part[h]);
        sq += ((sum.x * sum.x + sum.y * sum.y) + sum.z * sum.z) + sum.w * sum.w;
        for (int h = warp; h < g_size; h += kRWarps)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(wg, h) + lo +
                                     4 * x) = sum;
      }
      if (warp == 0) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
        if (lane < g_size) cluster.map_shared_rank(norms, lane)[rank] = sq;
      }
      ptx::cluster_sync();  // the whole w is in every CTA's wg
      if (emit_gate && it == n_upd - 1) {
        float pr = 0.f;
        for (int k = tid; k < c; k += kRThreads) pr += wg[k] * v[k];
        lam = block_sum<kRWarps>(pr, red);
        float q = 0.f;
        for (int k = tid; k < c; k += kRThreads) {
          const float d = wg[k] - lam * v[k];
          q += d * d;
        }
        resid = sqrtf(block_sum<kRWarps>(q, red));
      }
      float part[16];
#pragma unroll
      for (int h = 0; h < 16; ++h) part[h] = norms[h];
      float q = 0.f;
#pragma unroll
      for (int h = 0; h < 16; ++h)
        if (h < g_size) q += part[h];
      const float nrm = sqrtf(q) + 1e-30f;
      for (int k = tid; k < c; k += kRThreads) v[k] = wg[k] / nrm;
    }
    __syncthreads();
    for (int k = lo + tid; k < hi; k += kRThreads) v_out[slice * c + k] = v[k];
    if (rank == 0 && tid == 0) {
      lam_out[slice] = lam;
      resid_out[slice] = resid;
    }
  }
  ptx::cluster_sync();  // no CTA leaves while another may read its smem
}

// f(kernel) for the resident kernel of c; refuses what the streaming
// routes refuse (rows whose pitch is not a multiple of 16 bytes, c >
// kMaxCols)
template <typename T, typename F>
cudaError_t with_resident_kernel(int c, F&& f) {
  const int elt = static_cast<int>(sizeof(T));
  if (c < 1 || (c * elt) % 16 != 0 || c > kMaxCols)
    return cudaErrorInvalidValue;
  switch (chunks_per_lane<T>(c)) {
    case 1: return f(power_resident_kernel<T, 1>);
    case 2: return f(power_resident_kernel<T, 2>);
    case 4: return f(power_resident_kernel<T, 4>);
    case 8: return f(power_resident_kernel<T, 8>);
    case 16:
      if constexpr (sizeof(T) == 4) return f(power_resident_kernel<T, 16>);
      break;
  }
  return cudaErrorInvalidValue;
}

// the launch configuration of one cluster of g CTAs with smem bytes each,
// its attributes set on the kernel
template <typename K>
cudaError_t resident_config(K kernel, int g, size_t smem,
                            cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (g > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(g);
  cfg->blockDim = dim3(kRThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// clusters of the kernel resident on the card at once, cached per
// (device, kernel, g, smem): a launch inside a graph capture asks no more
// of the driver than the attributes
template <typename K>
cudaError_t resident_clusters(int device, K kernel, int g, size_t smem,
                              int* out) {
  struct Entry {
    int device;
    const void* kernel;
    int g;
    size_t smem;
    int clusters;
  };
  static Entry cache[64];
  static int n_cached = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_cached; ++i) {
    const Entry& en = cache[i];
    if (en.device == device && en.kernel == key && en.g == g &&
        en.smem == smem) {
      *out = en.clusters;
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = resident_config(kernel, g, smem, &cfg, &attr);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (*out < 1) return cudaErrorInvalidConfiguration;
  if (n_cached < 64) cache[n_cached++] = {device, key, g, smem, *out};
  return cudaSuccess;
}

// the shared memory a resident launch needs; 0 where g, band, n_res or
// per_bar cannot describe one
template <typename T>
size_t resident_smem(int r, int c, int g, int band, int n_res,
                     int per_bar) {
  if (g < 1 || g > 16 || band < 1 || static_cast<long>(g) * band < r ||
      n_res < 1 || n_res > band || per_bar < 1)
    return 0;
  const int n_bars = (n_res + per_bar - 1) / per_bar;
  const size_t bytes = resident_head(c, n_bars) +
                       static_cast<size_t>(n_res) * c * sizeof(T) +
                       resident_tail<T>(c);
  return bytes <= static_cast<size_t>(kMaxSmem) ? bytes : 0;
}

template <typename T>
cudaError_t launch_resident(int device, const void* t, const void* v0,
                            void* v_out, void* lam, void* resid, int b,
                            int r, int c, int g, int band, int n_res,
                            int per_bar, int n_upd, int lambda_pass,
                            int emit_gate, cudaStream_t stream) {
  const size_t smem = resident_smem<T>(r, c, g, band, n_res, per_bar);
  if (b < 0 || r < 1 || n_upd < 0 || smem == 0 ||
      reinterpret_cast<uintptr_t>(t) % 16)
    return cudaErrorInvalidValue;
  return with_resident_kernel<T>(c, [&](auto kernel) {
    int active = 0;
    cudaError_t e = resident_clusters(device, kernel, g, smem, &active);
    if (e != cudaSuccess || b == 0) return e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    e = resident_config(kernel, g, smem, &cfg, &attr);
    if (e != cudaSuccess) return e;
    cfg.gridDim = dim3(g * (b < active ? b : active));
    cfg.stream = stream;
    e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(t),
        static_cast<const float*>(v0), static_cast<float*>(v_out),
        static_cast<float*>(lam), static_cast<float*>(resid), b, r, c, g, band,
        n_res, per_bar, n_upd, lambda_pass, emit_gate);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t resident_clusters_for(int device, int r, int c, int g, int band,
                                  int n_res, int per_bar, int* out) {
  const size_t smem = resident_smem<T>(r, c, g, band, n_res, per_bar);
  if (smem == 0) return cudaErrorInvalidValue;
  return with_resident_kernel<T>(c, [&](auto kernel) {
    return resident_clusters(device, kernel, g, smem, out);
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

// The resident route: one cluster of g CTAs per slice, CTA i of a cluster
// on rows [i * band, (i + 1) * band), the first n_res of them held in its
// shared memory, one barrier per per_bar rows (power_iter.resident_plan
// gives g, band, n_res and per_bar).  It always normalizes and writes no
// w (power_matvec, one pass, never takes it).  Arguments otherwise as
// msc_power_iter's.
extern "C" int msc_power_iter_resident(int device, int dtype, const void* t,
                                       const void* v0, void* v_out,
                                       void* lam, void* resid, int b, int r,
                                       int c, int g, int band, int n_res,
                                       int per_bar, int n_upd,
                                       int lambda_pass, int emit_gate,
                                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_resident<float>(device, t, v0, v_out, lam, resid, b, r, c,
                                  g, band, n_res, per_bar, n_upd, lambda_pass,
                                  emit_gate, s);
  if (dtype == 1)
    return launch_resident<__nv_bfloat16>(device, t, v0, v_out, lam, resid, b,
                                          r, c, g, band, n_res, per_bar, n_upd,
                                          lambda_pass, emit_gate, s);
  return cudaErrorInvalidValue;
}

// the clusters of that plan resident on the card at once, into *out (a
// launch of b slices runs min(b, this) clusters, each walking its slices)
extern "C" int msc_power_iter_resident_clusters(int device, int dtype, int r,
                                                int c, int g, int band,
                                                int n_res, int per_bar,
                                                int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (dtype == 0)
    return resident_clusters_for<float>(device, r, c, g, band, n_res,
                                        per_bar, out);
  if (dtype == 1)
    return resident_clusters_for<__nv_bfloat16>(device, r, c, g, band, n_res,
                                                per_bar, out);
  return cudaErrorInvalidValue;
}

// the largest cluster the resident kernel may take on the card, into *out:
// 16 where it accepts a cluster beyond the portable 8, else 8
extern "C" int msc_power_iter_cluster_max(int device, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(power_resident_kernel<float, 1>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *out = e == cudaSuccess ? 16 : 8;
  cudaGetLastError();  // a refusal is an answer, not a sticky error
  return cudaSuccess;
}

extern "C" const char* msc_power_iter_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

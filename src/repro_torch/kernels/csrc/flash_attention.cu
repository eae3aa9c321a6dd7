// Online-softmax (flash) attention for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:_flash_kernel (the Pallas
// TPU kernel behind flash_attention).
//
// What it computes: o = softmax(mask(cap(q kᵀ · scale))) v for q (b, sq, d)
// and k, v (b, skv, d), b = batch x heads flattened by the caller.  cap is
// the optional tanh soft-cap t·tanh(s/t); the mask keeps key position kpos
// for query row i (global position qpos = i + q_offset) when kpos < skv and,
// if causal, kpos <= qpos and, with a window W, kpos > qpos - W.  Masked
// scores are -1e30, as in the Pallas body (not -inf).  Inputs are fp32 or
// bf16 (all three the same); scores, the running max m, the denominator l,
// the probabilities P and the accumulator are fp32, o = acc / (l + 1e-30)
// is written in the input dtype.  d is 32, 64, 128 or 256.
//
// What bounds it on this card: at the main path's shapes (whisper-tiny,
// d = 64) operations for the encoder's self-attention (4·s²·d flops on
// 4·s·d elements, 750 flops per bf16 byte at s = 1500) and bytes for the
// cross-attention (a few query rows over 1500 keys).  The scores never
// reach device memory.
//
// What the design does about it: one CTA of 256 threads owns 64 query rows
// of one (batch, head); the TPU's sequential kv grid axis becomes a loop
// inside the CTA over kv tiles of BK rows (64, or 32 at d = 256 so that the
// fp32 tiles fit shared memory).  The q tile stays in shared memory in fp32
// for the whole loop; each kv tile is staged in shared memory, K first and
// then V in the same buffer (rows padded by one float against bank
// conflicts).  Thread (ty, tx) of a 16 x 16 grid keeps rows ty + 16i
// (i < 4): a 4 x BK/16 block of scores and a 4 x d/16 block of the
// accumulator in registers; the row max and row sum are finished by a
// shuffle across the 16 lanes that share ty.  P goes through shared memory
// to the P·V product.  A kv tile is skipped only when the causal or window
// mask kills it for every row of the CTA; ragged sq and skv are masked in
// the kernel (padding rows read as 0 and are never written), so no padded
// copy is made.  softcap uses tanhf and the exponentials expf, not the fast
// approximations.  Not yet used: tensor cores (wgmma) with P in bf16 (a
// change of semantics), TMA, double buffering, a narrower CTA for sq = 1
// (each decode launch is b CTAs of one live row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;       // query rows per CTA
constexpr int RI = BQ / 16;  // query rows per thread
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;  // kv rows per tile
  static constexpr int CJ = BK / 16;             // score columns per thread
  static constexpr int DJ = D / 16;              // output columns per thread
  static constexpr int QP = D + 1;               // padded row of q
  static constexpr int KP = D + 1;               // padded row of k / v
  static constexpr int PP = BK + 1;              // padded row of P
  static constexpr size_t kSmemFloats =
      static_cast<size_t>(BQ) * QP + static_cast<size_t>(BK) * KP +
      static_cast<size_t>(BQ) * PP;
};

// rows [0, BK) of the kv tile starting at key k0 into buf (row stride KP),
// converted to fp32; rows at or past skv read as 0
template <typename T, int D>
__device__ __forceinline__ void stage_kv(float* buf, const T* __restrict__ src,
                                         int k0, int skv) {
  using C = Tile<D>;
  for (int e = threadIdx.x; e < C::BK * D; e += kThreads) {
    const int c = e / D, dd = e % D;
    const int gk = k0 + c;
    buf[c * C::KP + dd] =
        gk < skv ? to_f(src[static_cast<size_t>(gk) * D + dd]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
             int n_qt, float scale, int causal, int q_offset, int has_window,
             int window, int has_softcap, float softcap) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ x QP
  float* kv = qs + BQ * C::QP;       // BK x KP: K, then V, of one tile
  float* ps = kv + C::BK * C::KP;    // BQ x PP

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  q += static_cast<size_t>(bh) * sq * D;
  o += static_cast<size_t>(bh) * sq * D;
  k += static_cast<size_t>(bh) * skv * D;
  v += static_cast<size_t>(bh) * skv * D;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, dd = e % D;
    const int gr = q0 + r;
    qs[r * C::QP + dd] =
        gr < sq ? to_f(q[static_cast<size_t>(gr) * D + dd]) : 0.f;
  }

  float m[RI], l[RI], acc[RI][C::DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::DJ; ++j) acc[i][j] = 0.f;
  }

  // kv tiles the mask leaves alive for some live row of this CTA
  const int q_last = min(q0 + BQ, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_last + q_offset + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / C::BK) * C::BK;

  for (int k0 = k_begin; k0 < k_end; k0 += C::BK) {
    stage_kv<T, D>(kv, k, k0, skv);
    __syncthreads();

    float s[RI][C::CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < C::CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[RI], kk[C::CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * C::QP + dd];
#pragma unroll
      for (int j = 0; j < C::CJ; ++j) kk[j] = kv[(tx + 16 * j) * C::KP + dd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < C::CJ; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      const int qpos = row + q_offset;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < C::CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        bool keep = kpos < skv && row < sq;
        if (causal) keep = keep && kpos <= qpos;
        if (has_window) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? x : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes sharing ty sit in one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::DJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done with K
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < C::CJ; ++j)
        ps[(ty + 16 * i) * C::PP + tx + 16 * j] = s[i][j];
    stage_kv<T, D>(kv, v, k0, skv);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < C::BK; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + 16 * i) * C::PP + c];
#pragma unroll
      for (int j = 0; j < C::DJ; ++j) {
        const float vv = kv[c * C::KP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // every thread is done with V and P
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = l[i] + 1e-30f;
#pragma unroll
    for (int j = 0; j < C::DJ; ++j)
      o[static_cast<size_t>(row) * D + tx + 16 * j] = from_f<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int skv, float scale, int causal,
                   int q_offset, int has_window, int window, int has_softcap,
                   float softcap, cudaStream_t stream) {
  if (b < 0 || sq < 0 || skv < 1) return cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return cudaSuccess;
  const int n_qt = (sq + BQ - 1) / BQ;
  const long long n_cta = static_cast<long long>(b) * n_qt;
  if (n_cta > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = Tile<D>::kSmemFloats * sizeof(float);
  // above 48 KB of shared memory only with this opt-in
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_kernel<T, D><<<static_cast<unsigned>(n_cta), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, n_qt, scale,
      causal, q_offset, has_window, window, has_softcap, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* o, int b, int sq, int skv, float scale, int causal,
                     int q_offset, int has_window, int window,
                     int has_softcap, float softcap, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, skv, scale, causal, q_offset,
                           has_window, window, has_softcap, softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, skv, scale, causal, q_offset,
                           has_window, window, has_softcap, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, skv, scale, causal, q_offset,
                            has_window, window, has_softcap, softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, o, b, sq, skv, scale, causal, q_offset,
                            has_window, window, has_softcap, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Device pointers to contiguous tensors
// q and o (b, sq, d), k and v (b, skv, d), all of that dtype; d is 32, 64,
// 128 or 256.  causal, has_window and has_softcap are 0 or 1.  Returns a
// cudaError_t (0 = launched).
extern "C" int msc_flash_attention(int device, int dtype, int d,
                                   const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int skv, float scale, int causal,
                                   int q_offset, int has_window, int window,
                                   int has_softcap, float softcap,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, b, sq, skv, scale, causal,
                           q_offset, has_window, window, has_softcap, softcap,
                           s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, b, sq, skv, scale, causal,
                                   q_offset, has_window, window, has_softcap,
                                   softcap, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* msc_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// is written in the input dtype.  d is 32, 64, 128 or 256.  No TF32.
//
// What bounds it on this card: at the main path's shapes (whisper-tiny,
// d = 64) operations for the encoder's self-attention (4·s²·d flops on
// 4·s·d elements, 750 flops per bf16 byte at s = 1500) and bytes for the
// cross-attention (a few query rows over 1500 keys: 37 MB of bf16 K and V
// per decode call, 0.011 ms at 3.35 TB/s).  The scores never reach device
// memory.
//
// What the design does about it: msc_flash_attention takes one of three
// routes by sq and dtype, one launch per call whichever it takes.
//
// (a) sq <= SQ_SMALL, both dtypes (the decode cross-attention, one query
//     row per sequence and head): flash_small_kernel.  One CTA of 16 warps
//     per (b·h); each warp streams a contiguous slice of the keys the row
//     can see, with 16-byte loads in the input dtype, L lanes per key row
//     (L·16 B = one row, at most 32 lanes) and 4 keys per lane in flight.
//     Each lane group keeps an fp32 online softmax (expf, tanhf) on CUDA
//     cores; the groups of a warp merge by shuffles and the warps by the
//     log-sum-exp merge in shared memory, in a fixed order (m = max m_w,
//     l = Σ e^(m_w - m) l_w, the same for acc), so the result is the same
//     bits from run to run.  A slice that is empty enters the merge as
//     m = -1e30, l = 0, acc = 0 and vanishes.  Note: a row that no key
//     may be seen by averages v in the Pallas body and is 0 here; no
//     caller makes one.  Longer queries run one row per pass (re-reading
//     K and V), which is why only short ones take this route: SQ_SMALL is
//     set from the device times of both routes at sq = 1, 2, 4, 8, 16, 32
//     at the whisper cross shape (PERF.md).
// (b) bf16 at sq > SQ_SMALL: flash_mma_kernel, FlashAttention-2's
//     structure on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
//     accumulators).  A CTA is 8 warps, each owning 16 query rows: 128 rows
//     per CTA for long queries (K and V cross L2 once per 128 rows), and
//     for sq <= 64 fewer row groups times 2 or 4 key splits, each split
//     walking its own run of kv tiles, merged by log-sum-exp at the end, so
//     a short query still keeps 8 warps busy.  The Q fragments stay in
//     registers (d <= 128; at d = 256 they are read by ldmatrix per tile
//     and kv tiles are 16 keys, so the 16 x 256 fp32 accumulator fits
//     without spills).  K and V tiles (64 keys) are double-buffered in
//     shared memory by cp.async (rows padded by 16 B, a conflict-free
//     stride for ldmatrix) and read by ldmatrix (.trans for V).  S = Q·Kᵀ
//     in bf16 with fp32 accumulators gives the same numbers as the Pallas
//     body's upcast q·k in fp32 (bf16 products are exact in fp32).  Scale,
//     softcap, masks (only on tiles a mask cuts) and the online softmax
//     run on the fp32 S fragments in registers, and P is reused as the A
//     fragment of P·V without a trip through shared memory.  P·V keeps P
//     at near fp32: P = P_hi + P_lo, both bf16 (P_lo = bf16(P - P_hi)),
//     two mma calls on the same V fragments, and l is summed from the fp32
//     P.  Rounding P to bf16 once would change the reference's semantics
//     (its P and P·V are fp32): above 1e-4 of max |o| against the
//     split's under 1e-5 (tests/test_torch_flash.py pins both).
// (c) fp32 at sq > SQ_SMALL: flash_kernel on CUDA cores, as ported first:
//     one CTA of 256 threads owns 64 query rows; kv tiles of 64 rows (32 at
//     d = 256) staged in shared memory in fp32, K then V in one buffer;
//     each thread keeps 4 rows of scores and of the accumulator in
//     registers; P goes through shared memory to P·V.
//
// In (b) and (c) a kv tile is skipped only when the causal or window mask
// kills it for every row of the CTA, and a masked key adds
// exp(-1e30 - m) as in the Pallas body; in (a) each row reads only the
// keys it can see.  Ragged sq and skv are masked in the kernels
// (padding rows read as 0 and are never written), so no padded copy is
// made.  Not yet used: wgmma, TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "ptx.cuh"

namespace {

// the largest sq that takes the small-sq route (a)
constexpr int SQ_SMALL = 2;
constexpr int kRouteAuto = 0, kRouteSmall = 1, kRouteTile = 2;

// ---- (c) fp32 tile route: the kernel as first ported ---------------------

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


// ---- (a) small-sq route ---------------------------------------------------

constexpr int kSmallWarps = 16;

template <typename T, int D>
struct Small {
  static constexpr int VE = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int L = D / VE < 32 ? D / VE : 32;  // lanes per key row
  static constexpr int NV = D / (L * VE);  // 16 B vectors per lane and row
  static constexpr int E = NV * VE;        // elements per lane and row
  static constexpr int G = 32 / L;         // key rows per warp and step
};

// lane element j of vector n sits at column (n·L + lp)·VE + j of its row
template <typename T, int D>
__device__ __forceinline__ int small_col(int n, int lp) {
  return (n * Small<T, D>::L + lp) * Small<T, D>::VE;
}

__device__ __forceinline__ void unpack(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32's
__device__ __forceinline__ void unpack(const uint4& raw, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// one row's E elements of this lane, fp32
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int lp,
                                         float* f) {
  using S = Small<T, D>;
#pragma unroll
  for (int n = 0; n < S::NV; ++n)
    unpack(__ldg(reinterpret_cast<const uint4*>(row + small_col<T, D>(n, lp))),
           f + n * S::VE, T());
}

// one query row per pass (a decode step has one); U key rows per lane and
// step, all loaded before any is used
template <typename T, int D>
__global__ void __launch_bounds__(kSmallWarps * 32)
flash_small_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int sq,
                   int skv, float scale, int causal, int q_offset,
                   int has_window, int window, int has_softcap,
                   float softcap) {
  using S = Small<T, D>;
  constexpr int U = 4;
  constexpr int SW = D + 2;  // per warp: m, l, acc[D]
  __shared__ float red[kSmallWarps * SW];

  const size_t bh = blockIdx.x;
  q += bh * sq * D;
  o += bh * sq * D;
  k += bh * skv * D;
  v += bh * skv * D;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int lp = lane % S::L, gi = lane / S::L;

  for (int row = 0; row < sq; ++row) {
    const int qpos = row + q_offset;
    float qf[S::E];
    load_row<T, D>(q + static_cast<size_t>(row) * D, lp, qf);
    // the keys the row can see, cut into one slice per warp
    const int k_end = causal ? min(skv, qpos + 1) : skv;
    const int k_begin = has_window ? max(0, qpos - window + 1) : 0;
    const int n_live = max(0, k_end - k_begin);
    const int per = (n_live + kSmallWarps - 1) / kSmallWarps;
    const int ks = k_begin + w * per, ke = min(k_end, ks + per);

    float m = kNeg, l = 0.f, acc[S::E];
#pragma unroll
    for (int e = 0; e < S::E; ++e) acc[e] = 0.f;

    for (int kb = ks; kb < ke; kb += S::G * U) {
      float kf[U][S::E], vf[U][S::E];
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = kb + u * S::G + gi;
        in[u] = key < ke;
        if (in[u]) {
          load_row<T, D>(k + static_cast<size_t>(key) * D, lp, kf[u]);
          load_row<T, D>(v + static_cast<size_t>(key) * D, lp, vf[u]);
        } else {
#pragma unroll
          for (int e = 0; e < S::E; ++e) kf[u][e] = vf[u][e] = 0.f;
        }
      }
      float s[U];
      float mx = m;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < S::E; ++e) dot = fmaf(qf[e], kf[u][e], dot);
#pragma unroll
        for (int off = S::L / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float x = dot * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        // every key of the slice is one the row can see
        s[u] = in[u] ? x : kNeg;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < S::E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = in[u] ? expf(s[u] - mx) : 0.f;
        l += p;
#pragma unroll
        for (int e = 0; e < S::E; ++e) acc[e] = fmaf(p, vf[u][e], acc[e]);
      }
      m = mx;
    }

    // merge the G lane groups of the warp (both lanes of a pair compute
    // the same sums, so every group ends with the warp's state)
#pragma unroll
    for (int off = S::L; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, off);
      const float lo = __shfl_xor_sync(0xffffffffu, l, off);
      const float mm = fmaxf(m, mo);
      const float wa = expf(m - mm), wb = expf(mo - mm);
      l = wa * l + wb * lo;
#pragma unroll
      for (int e = 0; e < S::E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[e], off);
        acc[e] = wa * acc[e] + wb * ao;
      }
      m = mm;
    }
    if (gi == 0) {
      float* st = red + w * SW;
      if (lp == 0) {
        st[0] = m;
        st[1] = l;
      }
#pragma unroll
      for (int n = 0; n < S::NV; ++n)
#pragma unroll
        for (int j = 0; j < S::VE; ++j)
          st[2 + small_col<T, D>(n, lp) + j] = acc[n * S::VE + j];
    }
    __syncthreads();
    // merge the warps in order 0, 1, ...
    for (int dd = threadIdx.x; dd < D; dd += kSmallWarps * 32) {
      float mm = kNeg;
      for (int ww = 0; ww < kSmallWarps; ++ww)
        mm = fmaxf(mm, red[ww * SW]);
      float ls = 0.f, as = 0.f;
      for (int ww = 0; ww < kSmallWarps; ++ww) {
        const float* st = red + ww * SW;
        const float wt = expf(st[0] - mm);
        ls += wt * st[1];
        as += wt * st[2 + dd];
      }
      o[static_cast<size_t>(row) * D + dd] = from_f<T>(as / (ls + 1e-30f));
    }
    __syncthreads();  // red is free for the next row
  }
}

// ---- (b) bf16 tile route on the tensor cores ------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;

// A CTA is 8 warps: rg row groups of 16 query rows times ks key splits
// times NCH column parts (rg · ks · NCH = 8).  The warps of one split walk
// their own run of the CTA's kv tiles, and the splits are merged by
// log-sum-exp at the end, so a call with few query rows still keeps 8
// warps of loads and products in flight per CTA.  At d = 256 two warps
// share 16 rows, each computing S and its half of the output columns, so
// that a warp's accumulator is 16 x 128.
template <int D>
struct Mma {
  static constexpr int BK = D >= 256 ? 16 : 64;  // keys per kv tile
  static constexpr int LD = D + 8;  // padded row (elements): 16 B of pad
  static constexpr int NCH = D >= 256 ? 2 : 1;  // column parts per row group
  static constexpr int DC = D / NCH;            // output columns per warp
  static constexpr int WPC = kMmaWarps / NCH;   // warps per column part
  static constexpr int MAX_KS = D >= 128 ? 2 : 4;   // key splits that fit
  static constexpr int MIN_CTAS = D <= 64 ? 2 : 1;  // per SM, by registers
  // Q fragments in registers where the register budget allows; at d = 64
  // two CTAs of 8 warps share an SM's registers
  static constexpr bool QREG = D == 32 || D == 128;
  static constexpr int NS = BK / 8;   // n8 tiles of S
  static constexpr int NO = DC / 8;   // n8 tiles of the warp's output
  static constexpr int kTile = BK * LD;  // elements of one K or V tile

  // row groups for sq query rows
  static int row_groups(int sq) {
    int rg = sq > 64 ? 8 : sq > 32 ? 4 : 2;
    if (rg > WPC) rg = WPC;
    return rg > WPC / MAX_KS ? rg : WPC / MAX_KS;
  }
  // Q, then the kv tiles (split x 2 stages x {K, V}) or, after the loop, the
  // splits' (m, l, acc) rows for the merge
  static size_t smem(int rg) {
    const int ks = WPC / rg;
    const size_t qb = static_cast<size_t>(16 * rg) * LD * 2;
    const size_t ring = static_cast<size_t>(ks) * 4 * kTile * 2;
    const size_t merge =
        ks > 1 ? static_cast<size_t>(ks) * 16 * rg * (D + 2) * 4 : 0;
    return qb + (ring > merge ? ring : merge);
  }
};

// rows [r0, r0 + n) of a (rows, D) bf16 matrix into dst (stride LD), by
// 16-byte cp.async; rows at or past `rows` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int r0, int n, int rows) {
  constexpr int CH = D / 8;  // 16 B chunks per row
  for (int e = threadIdx.x; e < n * CH; e += kMmaThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = r0 + r < rows;
    ptx::cp_async16(dst + r * Mma<D>::LD + c,
                    ok ? src + static_cast<size_t>(r0 + r) * D + c : src,
                    ok ? 16 : 0);
  }
}

// the masks of one warp's kv tile: keys k0.., query row g at qpos0 (row
// g + 8 at qpos0 + 8)
struct Masks {
  int k0, qpos0, skv, causal, has_window, window;
};

// scale, softcap, masks and the online softmax on the S fragments of one
// kv tile (rows g and g + 8, keys k0 + 8n + 2t + j): S becomes P in place,
// m and this lane's share of l move on, and acc is rescaled
template <bool CAP, bool MASK, int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4],
                                             float (&acc)[NO][4],
                                             float (&m)[2], float (&l)[2],
                                             float scale, float softcap,
                                             const Masks& mk, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = mk.qpos0 + 8 * h;
    float mx = m[h];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[n][2 * h + j] * scale;
        if constexpr (CAP) x = softcap * tanhf(x / softcap);
        if constexpr (MASK) {
          const int key = mk.k0 + 8 * n + 2 * t + j;
          bool keep = key < mk.skv;
          if (mk.causal) keep = keep && key <= qpos;
          if (mk.has_window) keep = keep && key > qpos - mk.window;
          x = keep ? x : kNeg;
        }
        s[n][2 * h + j] = x;
        mx = fmaxf(mx, x);
      }
    // the 4 lanes of a quad share the row
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m[h] - mx);
    m[h] = mx;
    l[h] *= alpha;  // this lane's share of l; the quad sums at the end
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][2 * h] *= alpha;
      acc[n][2 * h + 1] *= alpha;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[n][2 * h + j] - mx);
        s[n][2 * h + j] = p;
        l[h] += p;
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, Mma<D>::MIN_CTAS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int sq, int skv, int n_qt,
                 int rg, float scale, int causal, int q_offset,
                 int has_window, int window, int has_softcap, float softcap) {
  using C = Mma<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_ks = C::WPC / rg, bq = 16 * rg;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + bq * C::LD;
  float* merge = reinterpret_cast<float*>(ring);
  // K (kv = 0) or V (kv = 1) tile of a split in a stage
  auto tile = [&](int split, int stage, int kv) {
    return ring + ((split * 2 + stage) * 2 + kv) * C::kTile;
  };

  const size_t bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * bq;
  q += bh * sq * D;
  o += bh * sq * D;
  k += bh * skv * D;
  v += bh * skv * D;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = w % C::NCH;  // column part
  const int wr = (w / C::NCH) % rg, wk = w / C::NCH / rg;  // rows, split
  const int row0 = q0 + 16 * wr;       // first query row of the warp

  // kv tiles the mask leaves alive for some live row of this CTA, dealt
  // to the splits in contiguous runs of `per`
  const int q_last = min(q0 + bq, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_last + q_offset + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / C::BK) * C::BK;
  const int n_t = k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK : 0;
  const int per = (n_t + n_ks - 1) / n_ks;
  auto load_kv = [&](int it, int stage) {
    for (int s = 0; s < n_ks; ++s) {
      const int ti = s * per + it;
      if (ti >= n_t) continue;
      load_tile<D>(tile(s, stage, 0), k, k_begin + ti * C::BK, C::BK, skv);
      load_tile<D>(tile(s, stage, 1), v, k_begin + ti * C::BK, C::BK, skv);
    }
  };

  load_tile<D>(qs, q, q0, bq, sq);
  if (per > 0) load_kv(0, 0);
  ptx::cp_async_commit();

  const bool live = row0 < sq;
  const __nv_bfloat16* qrow =
      qs + (16 * wr + (lane & 15)) * C::LD + (lane >> 4) * 8;
  uint32_t qf[C::QREG ? D / 16 : 1][4];
  float acc[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g and g + 8

  for (int it = 0; it < per; ++it) {
    // tile it has landed, and every warp is done with tile it - 1, whose
    // stage the next loads reuse: one barrier per tile
    ptx::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < per) load_kv(it + 1, (it + 1) & 1);
    ptx::cp_async_commit();
    if constexpr (C::QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ptx::ldmatrix_x4(qf[kk], qrow + 16 * kk);
      }
    }
    const int ti = wk * per + it;
    if (live && ti < n_t) {
      const int k0 = k_begin + ti * C::BK;
      const __nv_bfloat16* kst = tile(wk, it & 1, 0);
      const __nv_bfloat16* vst = tile(wk, it & 1, 1);

      // S = Q Kᵀ: 16 rows x BK keys per warp, fp32
      float s[C::NS][4];
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        if constexpr (C::QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          ptx::ldmatrix_x4(a, qrow + 16 * kk);
        }
        uint32_t b[C::NS / 2][4];
#pragma unroll
        for (int p = 0; p < C::NS / 2; ++p)
          ptx::ldmatrix_x4(
              b[p], kst + (16 * p + (lane & 7) + (lane >> 4) * 8) * C::LD +
                        16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int p = 0; p < C::NS / 2; ++p) {
          ptx::mma_bf16(s[2 * p], a, b[p][0], b[p][1]);
          ptx::mma_bf16(s[2 * p + 1], a, b[p][2], b[p][3]);
        }
      }

      // is any (row, key) of this warp's tile masked?  (rows at or past
      // sq are never written, so they need no mask)
      bool masked = k0 + C::BK > skv;
      if (causal) masked = masked || k0 + C::BK - 1 > row0 + q_offset;
      if (has_window) masked = masked || k0 <= row0 + 15 + q_offset - window;

      // scale, softcap, masks and the online softmax on the fragments,
      // with the tile's softcap and mask cases chosen once per tile
      const Masks mk{k0, row0 + g + q_offset, skv, causal, has_window,
                     window};
      if (has_softcap) {
        if (masked)
          softmax_tile<true, true>(s, acc, m, l, scale, softcap, mk, t);
        else
          softmax_tile<true, false>(s, acc, m, l, scale, softcap, mk, t);
      } else {
        if (masked)
          softmax_tile<false, true>(s, acc, m, l, scale, softcap, mk, t);
        else
          softmax_tile<false, false>(s, acc, m, l, scale, softcap, mk, t);
      }

      // acc += P V with P = P_hi + P_lo, two bf16 terms from the fp32 P
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        // A fragment of keys 16kk..16kk+15: S n-tiles 2kk and 2kk + 1
        const float pf[4][2] = {{s[2 * kk][0], s[2 * kk][1]},
                                {s[2 * kk][2], s[2 * kk][3]},
                                {s[2 * kk + 1][0], s[2 * kk + 1][1]},
                                {s[2 * kk + 1][2], s[2 * kk + 1][3]}};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[i] = ptx::pack_bf16(pf[i][0], pf[i][1]);
          // the bf16 bits are the high half of the fp32: exact
          lo[i] = ptx::pack_bf16(pf[i][0] - __uint_as_float(hi[i] << 16),
                                 pf[i][1] - __uint_as_float(hi[i] &
                                                            0xffff0000u));
        }
        // the P_hi products over every output tile, then the P_lo ones,
        // so that two products into one accumulator are far apart
        uint32_t b[C::DC / 16][4];
#pragma unroll
        for (int dp = 0; dp < C::DC / 16; ++dp)
          ptx::ldmatrix_x4_trans(
              b[dp], vst + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               C::LD +
                         wc * C::DC + 16 * dp + (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < C::DC / 16; ++dp) {
          ptx::mma_bf16(acc[2 * dp], hi, b[dp][0], b[dp][1]);
          ptx::mma_bf16(acc[2 * dp + 1], hi, b[dp][2], b[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < C::DC / 16; ++dp) {
          ptx::mma_bf16(acc[2 * dp], lo, b[dp][0], b[dp][1]);
          ptx::mma_bf16(acc[2 * dp + 1], lo, b[dp][2], b[dp][3]);
        }
      }
    }
  }
  ptx::cp_async_wait<0>();  // no copy outlives the loop (per = 0 loads none)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (n_ks == 1) {
    if (!live) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row >= sq) continue;
      const float den = l[h] + 1e-30f;
      __nv_bfloat16* orow = o + static_cast<size_t>(row) * D + wc * C::DC +
                            2 * t;
#pragma unroll
      for (int n = 0; n < C::NO; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            ptx::pack_bf16(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
    }
    return;
  }
  // each split's (m, l, acc) rows into shared memory (a split with no
  // tile is m = -1e30, l = 0, acc = 0 and vanishes), then the splits
  // merged by log-sum-exp in split order
  __syncthreads();  // the ring is no longer read
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* st = merge + (wk * bq + 16 * wr + g + 8 * h) * (D + 2);
    if (t == 0 && wc == 0) {  // the column parts hold the same m and l
      st[0] = m[h];
      st[1] = l[h];
    }
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      st[2 + wc * C::DC + 8 * n + 2 * t] = acc[n][2 * h];
      st[3 + wc * C::DC + 8 * n + 2 * t] = acc[n][2 * h + 1];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < bq * D; idx += kMmaThreads) {
    const int r = idx / D, dd = idx % D, row = q0 + r;
    if (row >= sq) break;  // rows only grow with idx
    float mm = kNeg;
    for (int s = 0; s < n_ks; ++s)
      mm = fmaxf(mm, merge[(s * bq + r) * (D + 2)]);
    float ls = 0.f, as = 0.f;
    for (int s = 0; s < n_ks; ++s) {
      const float* st = merge + (s * bq + r) * (D + 2);
      const float wt = expf(st[0] - mm);
      ls += wt * st[1];
      as += wt * st[2 + dd];
    }
    o[static_cast<size_t>(row) * D + dd] = __float2bfloat16(as / (ls + 1e-30f));
  }
}

// ---- launches ---------------------------------------------------------------

constexpr int kDevices = 64;

struct Call {
  int device;
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, skv;
  float scale;
  int causal, q_offset, has_window, window, has_softcap;
  float softcap;
};

// above 48 KB of shared memory only with this opt-in; `done` (one per
// kernel) keeps it to the first launch on each device
template <typename Kernel>
cudaError_t opt_in(bool (&done)[kDevices], Kernel kernel, size_t smem,
                   int device) {
  if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && device >= 0 && device < kDevices)
    done[device] = true;
  return e;
}

template <typename T, int D>
cudaError_t launch_flash(const Call& c, cudaStream_t stream) {
  static bool done[kDevices];
  const int n_qt = (c.sq + BQ - 1) / BQ;
  const long long n_cta = static_cast<long long>(c.b) * n_qt;
  if (n_cta > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = Tile<D>::kSmemFloats * sizeof(float);
  cudaError_t e = opt_in(done, flash_kernel<T, D>, smem, c.device);
  if (e != cudaSuccess) return e;
  flash_kernel<T, D><<<static_cast<unsigned>(n_cta), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k),
      static_cast<const T*>(c.v), static_cast<T*>(c.o), c.sq, c.skv, n_qt,
      c.scale, c.causal, c.q_offset, c.has_window, c.window, c.has_softcap,
      c.softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Call& c, cudaStream_t stream) {
  using C = Mma<D>;
  static bool done[kDevices];
  const int rg = C::row_groups(c.sq);
  const int n_qt = (c.sq + 16 * rg - 1) / (16 * rg);
  const long long n_cta = static_cast<long long>(c.b) * n_qt;
  if (n_cta > 2147483647LL) return cudaErrorInvalidValue;
  // the most any row-group count asks for
  size_t most = 0;
  for (int n : {32, 64, 128}) {
    const size_t need = C::smem(C::row_groups(n));
    if (need > most) most = need;
  }
  cudaError_t e = opt_in(done, flash_mma_kernel<D>, most, c.device);
  if (e != cudaSuccess) return e;
  flash_mma_kernel<D><<<static_cast<unsigned>(n_cta), kMmaThreads,
                        C::smem(rg), stream>>>(
      static_cast<const __nv_bfloat16*>(c.q),
      static_cast<const __nv_bfloat16*>(c.k),
      static_cast<const __nv_bfloat16*>(c.v),
      static_cast<__nv_bfloat16*>(c.o), c.sq, c.skv, n_qt, rg, c.scale,
      c.causal, c.q_offset, c.has_window, c.window, c.has_softcap, c.softcap);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_small(const Call& c, cudaStream_t stream) {
  flash_small_kernel<T, D><<<c.b, kSmallWarps * 32, 0, stream>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k),
      static_cast<const T*>(c.v), static_cast<T*>(c.o), c.sq, c.skv, c.scale,
      c.causal, c.q_offset, c.has_window, c.window, c.has_softcap, c.softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, int route, const Call& c, cudaStream_t s) {
  if (route == kRouteSmall)
    return dtype == 0 ? launch_small<float, D>(c, s)
                      : launch_small<__nv_bfloat16, D>(c, s);
  return dtype == 0 ? launch_flash<float, D>(c, s) : launch_mma<D>(c, s);
}

}  // namespace

extern "C" int msc_flash_sq_small() { return SQ_SMALL; }

// dtype: 0 = float32, 1 = bfloat16.  Device pointers to contiguous, 16-byte
// aligned tensors q and o (b, sq, d), k and v (b, skv, d), all of that
// dtype; d is 32, 64, 128 or 256.  causal, has_window and has_softcap are 0
// or 1.  route: 0 picks by sq (1, the small-sq kernel, for sq <= SQ_SMALL,
// else 2, the tile kernel of the dtype), 1 or 2 takes that route
// (for timing the routes against each other).  Returns a cudaError_t
// (0 = launched).
extern "C" int msc_flash_attention(int device, int dtype, int d,
                                   const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int skv, float scale, int causal,
                                   int q_offset, int has_window, int window,
                                   int has_softcap, float softcap, int route,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b < 0 || sq < 0 || skv < 1 || (dtype != 0 && dtype != 1) || route < 0 ||
      route > kRouteTile)
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  if (b == 0 || sq == 0) return cudaSuccess;
  if (route == kRouteAuto) route = sq <= SQ_SMALL ? kRouteSmall : kRouteTile;
  const Call c{device, q, k, v, o, b, sq, skv, scale, causal, q_offset,
               has_window, window, has_softcap, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_d<32>(dtype, route, c, s);
    case 64: return launch_d<64>(dtype, route, c, s);
    case 128: return launch_d<128>(dtype, route, c, s);
    case 256: return launch_d<256>(dtype, route, c, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* msc_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

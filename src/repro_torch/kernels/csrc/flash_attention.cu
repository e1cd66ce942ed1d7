// Flash attention, causal or full, with grouped KV heads: q [BHq, Sq, hd],
// k / v [BHkv, Sk, hd], q row b reads kv row b / group. Output in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// wrapper flash_attention_bhsd): one grid cell per (head, 128-row q
// block), the head's whole K/V in VMEM, 128-key chunks through the MXU
// with the online-softmax recurrence (fp32 m, l, acc). It computes what
// that kernel computes: q scaled by hd^-0.5 in fp32, the causal mask
// q_pos >= k_pos with no Sk - Sq offset (the wrapper takes causal only at
// Sq == Sk), masked scores -1e30, out = acc / max(l, 1e-30).
//
// What bounds it on the H100: at the serving path's shapes (Sq = Sk =
// 1024, hd = 128, fp32) it does 2 * S^2 * hd FLOPs per head for causal
// attention and reads each q, k, v byte once: ~256 FLOPs per byte, far
// above the card's balance point for the non-tensor fp32 rate, so it is
// bound by the fp32 FMA rate (67 TFLOP/s), not by memory.
// Design (simple and right first; wgmma / TMA come later): one block of
// 256 threads per (head, 64-row q tile), heaviest causal tiles launched
// first. The q tile (scaled), then each 64-key K and V tile, are staged
// in shared memory as fp32 (bf16 converted on load). Each thread owns a
// 4 x 4 block of the score tile (rows ty + 16 i, keys tx + 16 c) and the
// same 4 rows of the output accumulator (hd / 16 columns in float4
// chunks), so the 16 threads of a row group hold m and l of their rows
// and reduce row max / sum with shuffles inside a half warp. Scores go
// through shared memory once as probabilities for the P.V product.
// Causal tiles past the diagonal are skipped (their probabilities are
// exp(-1e30 - m) = 0 in the reference). Shared memory: 121 KB a block at
// hd = 128 (one block per SM), 219 KB at hd = 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 16;   // P row stride: two row groups of a warp on disjoint banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * (HD + 4) + kBK * HD + kBQ * kPS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int sk, int group, int n_qt, int causal, float scale) {
  constexpr int QS = HD + 4;   // q / k row stride: lanes tx 0..7 on distinct banks
  constexpr int NC = HD / 64;  // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int q0 = qt * kBQ;
  const T* qb = q + static_cast<size_t>(bh) * sq * HD;
  const T* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const T* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  for (int i = tid; i < kBQ * HD / 4; i += kThreads) {
    const int r = i / (HD / 4);
    const int c = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) {
      x = load4(qb + static_cast<size_t>(q0 + r) * HD + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    store4(Qs + r * QS + c, x);
  }

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[i][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int n_kt = (sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K / V / P reads are done
    for (int i = tid; i < kBK * HD / 4; i += kThreads) {
      const int r = i / (HD / 4);
      const int c = (i % (HD / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < sk) {
        kx = load4(kb + static_cast<size_t>(k0 + r) * HD + c);
        vx = load4(vb + static_cast<size_t>(k0 + r) * HD + c);
      }
      store4(Ks + r * QS + c, kx);
      store4(Vs + r * HD + c, vx);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = load4(Ks + (tx + 16 * c) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        if (kp >= sk) {
          s[i][c] = -CUDART_INF_F;  // past the keys: probability exactly 0
        } else if (causal && qp < kp) {
          s[i][c] = kNegInf;
        }
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = row_max16(mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
        Ps[(ty + 16 * i) * kPS + tx + 16 * c] = s[i][c];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        acc[i][cc].x *= alpha;
        acc[i][cc].y *= alpha;
        acc[i][cc].z *= alpha;
        acc[i][cc].w *= alpha;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(Ps + (ty + 16 * i) * kPS + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float4 vv = load4(Vs + (j + e) * HD + 64 * cc + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = get(pv[i], e);
            acc[i][cc].x = fmaf(p, vv.x, acc[i][cc].x);
            acc[i][cc].y = fmaf(p, vv.y, acc[i][cc].y);
            acc[i][cc].z = fmaf(p, vv.z, acc[i][cc].z);
            acc[i][cc].w = fmaf(p, vv.w, acc[i][cc].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* ob = o + (static_cast<size_t>(bh) * sq + row) * HD;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const float4 a = acc[i][cc];
      store4(ob + 64 * cc + 4 * tx,
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int group, int sq, int sk, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(n_qt) * bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_attention_kernel<T, HD><<<static_cast<unsigned>(blocks), kThreads,
                                  smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, group, n_qt,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int bh,
              int group, int sq, int sk, int hd, int causal, float scale,
              cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, bh, group, sq, sk, causal, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, group, sq, sk, causal, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, o, bh, group, sq, sk, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); nothing is launched for an empty problem.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh,
                                      int group, int sq, int sk, int hd,
                                      int dtype, int causal, float scale,
                                      void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, bh, group, sq, sk, hd, causal, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, bh, group, sq, sk, hd, causal,
                                    scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

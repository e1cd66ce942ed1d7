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
// 1024, hd = 128, fp32, causal, 128 q heads) the two products are 34.36
// GFLOP and it reads each q, k, v byte once, ~256 FLOPs per byte: bound by
// arithmetic, not memory. In fp32 outside the tensor cores that is 34.36
// GFLOP / 67 TFLOP/s = 0.513 ms. On the tensor cores in TF32 it is 3 x
// 34.36 GFLOP / 495 TFLOP/s = 0.208 ms, the three products below.
//
// Numerics: the reference test holds fp32 attention to 2e-5, which one
// TF32 pass (an 11-bit significand, ~5e-4 per product) misses. So every
// product is split as 3xTF32: x_hi = tf32(x), x_lo = tf32(x - x_hi),
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the small terms first; the
// dropped a_lo.b_lo is ~2^-22 relative), accumulated in fp32. tf32(x) is
// cvt.rna.tf32.f32 (round to nearest, ties away from zero) with the 13
// low bits cleared. A bf16 K or V value is exact in TF32 (x_lo = 0), so
// its products take two terms. q is scaled in fp32 before its split.
//
// Design: mma.sync.m16n8k8 TF32 with fp32 accumulators, register
// fragments, no descriptors.
// - A block of 8 warps owns 128 q rows of one head; each warp owns 16 rows
//   and keeps its S tile, its O accumulator and the online-softmax state
//   (m, l) of its rows in registers. Row max and row sum are reduced
//   across the quad of threads that share a row, by shuffles.
// - Each 8-key block of S sums its hd / 8 steps in one accumulator per
//   product (three at fp32), so the dependent mma chains are hd / 8 long,
//   not 3 hd / 8; they are added, small terms first, before the softmax.
// - P goes from the S accumulators straight into the A fragment of the
//   P.V product. The accumulator holds keys (2t, 2t+1) of each 8-key
//   block where the A fragment wants (t, t+4): the P.V product reads its
//   8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7, and the V fragment is
//   loaded in that order (keys 2t and 2t+1), so nothing is shuffled.
// - K and V tiles of BK = 64 keys are staged with cp.async (16 bytes a
//   thread, rows past Sk zero-filled) in two stages: tile t+1 loads while
//   tile t is multiplied. They are staged in the input dtype (bf16
//   widened at fragment load) and split into hi / lo at fragment load;
//   the scaled q tile is staged once as fp32. Rows are padded (fp32:
//   hd + 4, bf16: hd + 8 elements) so that every fragment load of a warp
//   hits 32 distinct banks. Shared memory at hd = 128: 198 KB (fp32),
//   134 KB (bf16), one block per SM.
// - hd = 256: 4 warps, 32-key tiles and one S accumulator per block (the
//   O accumulator alone takes 128 registers).
// - Blocks run the heaviest causal q tiles of every head first; a warp
//   skips a causal K/V tile wholly past its last row (its probabilities
//   are exp(-1e30 - m) = 0 in the reference), and only the tiles that
//   straddle the diagonal or the end of the keys are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

// Tile shape of one instantiation: 8 warps (128 q rows) sharing 64-key
// K / V tiles; at hd = 256, 4 warps and 32-key tiles (shared memory).
template <typename T, int HD>
struct Cfg {
  static constexpr int kWarps = HD >= 256 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;          // q rows per block
  static constexpr int BK = HD >= 256 ? 32 : 64;   // keys per K / V tile
  static constexpr int QS = HD + 4;                // fp32 q row stride
  // staged K / V row stride, in elements of T
  static constexpr int KS = sizeof(T) == 4 ? HD + 4 : HD + 8;
  // S accumulators per 8-key block: one per product where registers
  // allow (hd = 256 holds a 128-register O accumulator)
  static constexpr int NS = HD >= 256 ? 1 : (sizeof(T) == 4 ? 3 : 2);
  static constexpr size_t kSmem =
      sizeof(float) * kBQ * QS + sizeof(T) * 2 * 2 * BK * KS;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// tf32(x): round to nearest, ties away from zero, 13 low bits cleared
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a . b over one m16n8k8 TF32 tile, fp32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a . b as 3xTF32 into c_hh (a_hi.b_hi), c_lh (a_lo.b_hi) and c_hl
// (a_hi.b_lo), which may be one accumulator, small terms first; b exact
// in TF32 (a bf16 value) takes two products
template <bool kB16>
__device__ __forceinline__ void mma3(float (&c_hh)[4], float (&c_lh)[4],
                                     float (&c_hl)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  if constexpr (kB16) {
    mma(c_lh, al, __float_as_uint(b0), __float_as_uint(b1));
    mma(c_hh, ah, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t h0, l0, h1, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma(c_lh, al, h0, h1);
    mma(c_hl, ah, l0, l1);
    mma(c_hh, ah, h0, h1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int bhq,
                       int sq, int sk, int group, int n_qt, int causal,
                       float scale) {
  using C = Cfg<T, HD>;
  constexpr bool kB16 = sizeof(T) == 2;
  constexpr int kThreads = C::kThreads;
  constexpr int kBQ = C::kBQ;
  constexpr int BK = C::BK;
  constexpr int QS = C::QS;
  constexpr int KS = C::KS;
  constexpr int NS = C::NS;
  constexpr int NB = BK / 8;           // 8-key blocks of a tile
  constexpr int ND = HD / 8;           // 8-dim blocks of a row
  constexpr int CH = 16 / sizeof(T);   // elements of one 16-byte copy
  constexpr int CPR = HD / CH;         // copies per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  T* KV = reinterpret_cast<T*>(Qs + kBQ * QS);   // [stage][K, V][BK][KS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;   // fragment row group
  const int t4 = tid & 3;          // thread in the quad
  // heaviest causal q tiles of every head first
  const int bh = static_cast<int>(blockIdx.x % bhq);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / bhq);
  const int q0 = qt * kBQ;
  const T* qb = q + static_cast<size_t>(bh) * sq * HD;
  const T* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const T* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / BK + 1);
  auto load_tile = [&](int t) {
    const int k0 = t * BK;
    T* kd = KV + (t & 1) * 2 * BK * KS;
    T* vd = kd + BK * KS;
    for (int i = tid; i < BK * CPR; i += kThreads) {
      const int r = i / CPR;
      const int c = (i % CPR) * CH;
      const bool ok = k0 + r < sk;
      const size_t src = static_cast<size_t>(ok ? k0 + r : 0) * HD + c;
      cp_async16(kd + r * KS + c, kb + src, ok);
      cp_async16(vd + r * KS + c, vb + src, ok);
    }
  };
  load_tile(0);
  cp_async_commit();

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
    *reinterpret_cast<float4*>(Qs + r * QS + c) = x;
  }

  const int r0 = q0 + 16 * warp;   // the warp's first q row
  const float* qw = Qs + (16 * warp + g) * QS + t4;
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};   // rows g and g + 8
  float l_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_kt; ++t) {
    // two stages: tile t + 1 loads while tile t is multiplied
    if (t + 1 < n_kt) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();   // tile t (and, at t = 0, the q tile) is in place
    const int k0 = t * BK;
    if (!causal || k0 <= r0 + 15) {
      const T* Kt = KV + (t & 1) * 2 * BK * KS;
      const T* Vt = Kt + BK * KS;

      // ---- S = (q * scale) . K^T over the tile; each 8-key block sums
      // its hd / 8 steps in NS accumulators (the products apart: NS
      // dependent chains instead of one NS times as long), added small
      // terms first at the end
      float s[NS][NB][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        const float* qr = qw + kk * 8;
        uint32_t ah[4], al[4];
        split(qr[0], ah[0], al[0]);
        split(qr[8 * QS], ah[1], al[1]);
        split(qr[4], ah[2], al[2]);
        split(qr[8 * QS + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const T* kr = Kt + (j * 8 + g) * KS + kk * 8 + t4;
          mma3<kB16>(s[0][j], s[NS > 1 ? 1 : 0][j], s[NS - 1][j], ah, al,
                     to_float(kr[0]), to_float(kr[4]));
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (NS == 3) s[0][j][e] += s[1][j][e] + s[2][j][e];
          if (NS == 2) s[0][j][e] += s[1][j][e];
        }

      // ---- mask, online softmax (rows g and g + 8 of the warp)
      if ((causal && k0 + BK - 1 > r0) || k0 + BK > sk) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
            const int qp = r0 + g + 8 * (e >> 1);
            if (kp >= sk) {
              s[0][j][e] = -CUDART_INF_F;   // past the keys: probability 0
            } else if (causal && qp < kp) {
              s[0][j][e] = kNegInf;
            }
          }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[0][j][0], s[0][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[0][j][2], s[0][j][3]));
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = expf(m_r[i] - mx[i]);
        m_r[i] = mx[i];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[0][j][e] = expf(s[0][j][e] - mx[e >> 1]);
          rs[e >> 1] += s[0][j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }

      // ---- O += P . V, 8 keys at a time in the order (2t, 2t + 1)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t ph[4], pl[4];
        split(s[0][j][0], ph[0], pl[0]);
        split(s[0][j][2], ph[1], pl[1]);
        split(s[0][j][1], ph[2], pl[2]);
        split(s[0][j][3], ph[3], pl[3]);
        const T* vr = Vt + (j * 8 + 2 * t4) * KS + g;
#pragma unroll
        for (int d = 0; d < ND; ++d)
          mma3<kB16>(acc[d], acc[d], acc[d], ph, pl, to_float(vr[d * 8]),
                     to_float(vr[KS + d * 8]));
      }
    }
    __syncthreads();   // stage t & 1 is read: tile t + 2 may overwrite it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
    T* ob = o + (static_cast<size_t>(bh) * sq + row) * HD + 2 * t4;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store2(ob + d * 8, acc[d][2 * i] / den, acc[d][2 * i + 1] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int group, int sq, int sk, int causal, float scale,
           cudaStream_t stream) {
  using C = Cfg<T, HD>;
  constexpr size_t smem = C::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (sq + C::kBQ - 1) / C::kBQ;
  const long long blocks = static_cast<long long>(n_qt) * bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_attention_kernel<T, HD><<<static_cast<unsigned>(blocks),
                                  C::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, sq, sk, group, n_qt,
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

// Mamba's selective scan over a whole sequence, in one launch:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t     (per channel d,
//   y_t = sum_n h_t[n] * C_t[n] + D * u_t                   state n)
// with u, dt, y [B, S, di] float32, B_t / C_t [B, S, N], A [di, N], D
// [di], h0 / hT [B, di, N].
//
// Replaces the reference's chunked selective scan,
// src/repro/models/mamba.py:59 (_chunk_scan, an associative_scan, :63)
// inside the remat'd lax.scan over chunks of mamba_seq (:85-106). That is
// not a Pallas kernel: XLA builds the [B, chunk, di, N] float32 tensors
// dA, dBu, their prefix products and sums and hs for every chunk, and the
// chunk exists only to bound them. Here none of them exists: h stays in
// registers, so the whole sequence runs in one launch with no chunking.
//
// What bounds it on the H100: bytes. Each (b, t, d) reads u and dt and
// writes y (12 bytes) and does ~7 float operations for each of N states
// plus an exp: at N = 16 ~112 operations against 12 bytes, below the
// card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 operations a byte).
// Design: each channel (b, d) gets N lanes, one state each, so a warp
// holds 32 / N channels and a block of 256 threads 256 / N channels
// (16 at N = 16: B * di * N threads in all, 524288 at jamba's prefill).
// The block walks the sequence in tiles of kTile tokens: it stages the
// tile's B_t and C_t (shared by all its channels) and its channels' u and
// dt in shared memory, coalesced, then each lane runs the recurrence for
// its state through the tile and the channel's N lanes reduce y with
// xor shuffles of width N; the tile's y goes out through shared memory.
// Every lane runs every shuffle: a channel past di (the tail block) runs
// on zeros and stores nothing. N is a template parameter (8 or 16); the
// C entry refuses any other.
//
// Numerics: the products are the reference's (dt * A, then exp; dt * u,
// then times B); the recurrence runs token by token in float32 (the
// compiler may fuse a multiply and an add into an fma), and y sums its
// N terms as a butterfly. The plain version,
// repro_torch.kernels.ref.selective_scan_ref, runs the same recurrence
// token by token with tensor ops.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // tokens staged at a time

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ A,
                      const float* __restrict__ D,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int S, int di) {
  constexpr int kChan = kThreads / N;   // channels a block
  __shared__ float sB[kTile][N];
  __shared__ float sC[kTile][N];
  __shared__ float su[kTile][kChan];
  __shared__ float sdt[kTile][kChan];
  __shared__ float sy[kTile][kChan];

  const int n = threadIdx.x % N;
  const int c = threadIdx.x / N;
  const int blocks_per_row = (di + kChan - 1) / kChan;
  const int b = blockIdx.x / blocks_per_row;
  const int d0 = (blockIdx.x % blocks_per_row) * kChan;
  const int d = d0 + c;
  const bool valid = d < di;
  const long long state = (static_cast<long long>(b) * di + d) * N + n;
  const float a = valid ? A[static_cast<long long>(d) * N + n] : 0.f;
  const float dd = valid ? D[d] : 0.f;
  float h = valid ? h0[state] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int tt = min(kTile, S - t0);
    const long long row0 = static_cast<long long>(b) * S + t0;
    for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
      const int r = i / N, k = i % N;
      float vb = 0.f, vc = 0.f;
      if (r < tt) {
        const long long off = (row0 + r) * N + k;
        vb = Bm[off];
        vc = Cm[off];
      }
      sB[r][k] = vb;
      sC[r][k] = vc;
    }
    for (int i = threadIdx.x; i < kTile * kChan; i += kThreads) {
      const int r = i / kChan, k = i % kChan;
      float vu = 0.f, vd = 0.f;
      if (r < tt && d0 + k < di) {
        const long long off = (row0 + r) * di + d0 + k;
        vu = u[off];
        vd = dt[off];
      }
      su[r][k] = vu;
      sdt[r][k] = vd;
    }
    __syncthreads();
    for (int r = 0; r < tt; ++r) {   // tt is the block's: every lane loops
      const float ut = su[r][c];
      const float dtt = sdt[r][c];
      h = expf(dtt * a) * h + (dtt * ut) * sB[r][n];
      float p = h * sC[r][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, off, N);
      }
      if (n == 0) sy[r][c] = p + ut * dd;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kChan; i += kThreads) {
      const int r = i / kChan, k = i % kChan;
      if (r < tt && d0 + k < di) {
        y[(row0 + r) * di + d0 + k] = sy[r][k];
      }
    }
    // the next tile's staging writes sB / sC / su / sdt, last read before
    // the barrier above; sy is written again only after the next barrier
  }
  if (valid) hT[state] = h;
}

template <int N>
int launch(const float* u, const float* dt, const float* Bm,
           const float* Cm, const float* A, const float* D, const float* h0,
           float* y, float* hT, int B, int S, int di, cudaStream_t stream) {
  constexpr int kChan = kThreads / N;
  const long long blocks =
      static_cast<long long>(B) * ((di + kChan - 1) / kChan);
  selective_scan_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(u, dt, Bm, Cm, A, D, h0, y, hT, S, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int selective_scan_launch(const float* u, const float* dt,
                                     const float* Bm, const float* Cm,
                                     const float* A, const float* D,
                                     const float* h0, float* y, float* hT,
                                     int B, int S, int di, int N,
                                     cudaStream_t stream) {
  if (N == 8) return launch<8>(u, dt, Bm, Cm, A, D, h0, y, hT, B, S, di,
                               stream);
  if (N == 16) return launch<16>(u, dt, Bm, Cm, A, D, h0, y, hT, B, S, di,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Mamba1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/mamba_scan/kernel.py: mamba_scan_pallas (body
// _scan_kernel).
//
// What it computes.  For every batch row and channel d, over the padded
// positions t = 0 .. s_pad-1 in order, with f32 state h[d, :] from h0:
//   h_t = exp(dt_t[d] · A[d, :]) ∘ h_{t-1} + (dt_t[d] · x_t[d]) · B_t
//   y_t[d] = Σ_j h_t[d, j] · C_t[j]
// and the state after the last position.  Layouts as the Pallas kernel:
// x/dt/y (b, s_pad, di), B/C (b, s_pad, ds), A (di, ds), h0/h (b, di, ds),
// all f32, contiguous.  The wrapper (kernels/mamba_scan/ops.py) pads the
// positions to the scan chunk (SSM_CHUNK = 16) with dt = x = B = C = 0:
// those steps multiply h by exp(0) = 1 and add 0, so they leave it
// bitwise unchanged.  They are computed all the same, as on the TPU: the
// scan-chunk granularity M_ssm is real work here too.
//
// Design.  The TPU kernel carries the state in VMEM across a sequential
// chunk axis of its grid; CUDA blocks run in no order, so the time loop
// moves inside the block.  A channel's ds states are split over a group of
// G adjacent lanes, S = kStatesPerLane states each (G = ds / S rounded up
// to a power of two; the states past ds have A = B = C = h0 = 0 and stay
// 0, so every ds in 1..64 runs).  A lane keeps its S states and its S
// entries of A·log2(e) in registers and reads and writes them at adjacent
// addresses, so h0, A and h move coalesced.  A block of 128 threads covers
// 128 / G channels of one batch row: grid (ceil(di·G / 128), b), 1024
// blocks (31 warps per SM) at falcon decode (b = 4, di = 8192, ds = 16,
// S = 4).  Positions go in chunks of 16: the block copies a chunk's x, dt,
// B and C into shared memory by cp.async (16-byte copies where the widths
// and addresses allow, else 4-byte ones; zero past s_pad, di and ds), the
// next chunk's copies in flight while this one is computed, one barrier
// per chunk.  Every channel of a row reads the same B_t and C_t, so a
// lane's S entries are broadcast reads of shared memory.  Per step a lane
// computes its S states (exp as ex2.approx of dt·A·log2(e): one MUFU op;
// ex2 of ±0 is exactly 1, so a padded step stays an identity) and its
// partial of y in state order.  All 16 steps of a chunk run without a
// branch (steps past s_pad read zeros: identities), so the compiler
// interleaves them.  After the chunk the group sums its partials by
// __shfl_xor_sync in a fixed pairwise tree over lanes 1, 2, .., G/2 apart
// (reduce_steps; y depends on no batch size, padding or grid), and each
// lane stores 16 / G steps of y.  The final state is written once.
//
// What bounds it.  Bytes: at falcon decode x, dt, y, A, h0 and h come to
// ~11 MB, 3.3 us at 3.35 TB/s; the 8.4 M exps take 2.3 us at 16 MUFU ops
// per clock per SM.  The only serial dependence is one multiply-add per
// state and step (exp(dt·A) and dt·x·B do not depend on h), so a
// chunk-parallel scan over positions would buy nothing at serving lengths:
// what the design does is fill the card and keep the loads ahead.
//
// Accepted inputs: f32, contiguous, 1 <= ds <= 64, di >= 1, s_pad >= 1.
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kThreads = 128;
constexpr int kSteps = 16;          // positions of one chunk (SSM_CHUNK)
constexpr int kStatesPerLane = 4;   // S
constexpr int kMaxState = 64;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* x;      // (b, s_pad, di)
  const float* dt;     // (b, s_pad, di)
  const float* b_in;   // (b, s_pad, ds)
  const float* c_in;   // (b, s_pad, ds)
  const float* a;      // (di, ds)
  const float* h0;     // (b, di, ds)
  float* y;            // (b, s_pad, di)
  float* h_out;        // (b, di, ds)
  int s_pad, di, ds;
  bool vec;            // di, ds % 4 == 0 and 16-byte-aligned bases
};

// S consecutive floats at an address aligned to 4·S bytes
template <int S>
__device__ inline void ld_vec(const float* src, float (&v)[S]) {
  if constexpr (S == 4) {
    const float4 w = *reinterpret_cast<const float4*>(src);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    const float2 w = *reinterpret_cast<const float2*>(src);
    v[0] = w.x; v[1] = w.y;
  }
}

template <int S>
__device__ inline void st_vec(float* dst, const float (&v)[S]) {
  if constexpr (S == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

__device__ inline float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// y of a chunk: each lane holds its partial of every step; the group sums
// them pairwise over lanes O = 1, 2, .. apart.  At each level a lane keeps
// half of its N steps (the lower half where its bit O is 0), adds the
// partner's partials of those and hands over the other half, so it ends
// with kSteps / G consecutive steps from `base`.  Per step that is the
// butterfly's fixed tree ((p0 + p1) + (p2 + p3)) + .., in kSteps·(1 − 1/G)
// shuffles per chunk where a butterfly per step takes kSteps·log2(G).
template <int G, int O = 1, int N = kSteps>
__device__ inline void reduce_steps(float (&yp)[kSteps], int gl, int& base) {
  if constexpr (O < G) {
    const bool up = gl & O;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float keep = up ? yp[k + N / 2] : yp[k];
      const float give = up ? yp[k] : yp[k + N / 2];
      yp[k] = keep + __shfl_xor_sync(0xffffffffu, give, O);
    }
    if (up) base += N / 2;
    reduce_steps<G, 2 * O, N / 2>(yp, gl, base);
  }
}

template <int S, int G>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Params p) {
  static_assert(S == 2 || S == 4, "states per lane");
  static_assert(G <= kSteps, "a lane ends with at least one step of y");
  constexpr int kCh = kThreads / G;   // channels of one block
  constexpr int kGS = G * S;          // a channel's states, rounded up
  __shared__ __align__(16) float sx[2][kSteps][kCh];
  __shared__ __align__(16) float sdt[2][kSteps][kCh];
  __shared__ __align__(16) float sb[2][kSteps][kGS];
  __shared__ __align__(16) float sc[2][kSteps][kGS];
  const int row = blockIdx.y, tid = threadIdx.x;
  const int c = tid / G, gl = tid % G;     // channel in the block, lane in the group
  const int d0 = blockIdx.x * kCh, d = d0 + c, j0 = gl * S;
  const bool live = d < p.di, owns = live && j0 < p.ds;
  const size_t seq = (size_t)row * p.s_pad;
  const uint32_t x_s = smem_addr(sx), dt_s = smem_addr(sdt), b_s = smem_addr(sb),
                 c_s = smem_addr(sc);

  // x, dt, B and C of chunk ci into stage st, zero past s_pad, di and ds
  auto load_chunk = [&](int ci, int st) {
    const int t0 = ci * kSteps;
    const int w = p.vec ? 4 : 1;
    const int xw = kCh / w, bw = kGS / w;
    for (int i = tid; i < kSteps * xw; i += kThreads) {
      const int tt = i / xw, cc = (i - tt * xw) * w;
      const bool ok = t0 + tt < p.s_pad && d0 + cc < p.di;
      const size_t off = ok ? (seq + t0 + tt) * p.di + d0 + cc : 0;
      const uint32_t at = 4u * (uint32_t)((st * kSteps + tt) * kCh + cc);
      const uint32_t dx = x_s + at, dd = dt_s + at;
      if (p.vec) {
        cp_async16(dx, p.x + off, ok);
        cp_async16(dd, p.dt + off, ok);
      } else {
        cp_async4(dx, p.x + off, ok);
        cp_async4(dd, p.dt + off, ok);
      }
    }
    for (int i = tid; i < kSteps * bw; i += kThreads) {
      const int tt = i / bw, j = (i - tt * bw) * w;
      const bool ok = t0 + tt < p.s_pad && j < p.ds;
      const size_t off = ok ? (seq + t0 + tt) * p.ds + j : 0;
      const uint32_t at = 4u * (uint32_t)((st * kSteps + tt) * kGS + j);
      const uint32_t db = b_s + at, dc = c_s + at;
      if (p.vec) {
        cp_async16(db, p.b_in + off, ok);
        cp_async16(dc, p.c_in + off, ok);
      } else {
        cp_async4(db, p.b_in + off, ok);
        cp_async4(dc, p.c_in + off, ok);
      }
    }
  };

  const int chunks = (p.s_pad + kSteps - 1) / kSteps;
  load_chunk(0, 0);
  cp_async_commit();

  // this lane's states and A·log2(e), while the first chunk lands
  float h[S], a2[S];
  const size_t state = ((size_t)row * p.di + d) * p.ds + j0;
  const size_t arow = (size_t)d * p.ds + j0;
  if (owns && p.vec) {
    ld_vec<S>(p.h0 + state, h);
    ld_vec<S>(p.a + arow, a2);
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const bool on = owns && j0 + i < p.ds;
      h[i] = on ? p.h0[state + i] : 0.f;
      a2[i] = on ? p.a[arow + i] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) a2[i] *= kLog2e;

  for (int ci = 0; ci < chunks; ++ci) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ci has landed; the stage refilled next is consumed
    if (ci + 1 < chunks) load_chunk(ci + 1, (ci + 1) & 1);
    cp_async_commit();
    const int st = ci & 1, t0 = ci * kSteps;
    // every step of the chunk, those past s_pad on zeros (identities);
    // this lane's partial of y per step
    float yp[kSteps];
#pragma unroll
    for (int tt = 0; tt < kSteps; ++tt) {
      const float dv = sdt[st][tt][c];
      const float dtx = dv * sx[st][tt][c];
      float bv[S], cv[S];
      ld_vec<S>(&sb[st][tt][j0], bv);
      ld_vec<S>(&sc[st][tt][j0], cv);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        h[i] = fmaf(ex2(dv * a2[i]), h[i], dtx * bv[i]);
        acc = fmaf(h[i], cv[i], acc);
      }
      yp[tt] = acc;
    }
    int base = 0;
    reduce_steps<G>(yp, gl, base);
#pragma unroll
    for (int k = 0; k < kSteps / G; ++k) {
      const int t = t0 + base + k;
      if (live && t < p.s_pad) p.y[(seq + t) * p.di + d] = yp[k];
    }
  }

  if (owns && p.vec) {
    st_vec<S>(p.h_out + state, h);
  } else if (owns) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (j0 + i < p.ds) p.h_out[state + i] = h[i];
    }
  }
}

// the narrowest power-of-two group G with G·S >= ds (at most kSteps lanes)
template <int S, int G = 1>
int launch(const Params& p, int bsz, cudaStream_t stream) {
  if constexpr (G < kSteps) {
    if (G * S < p.ds) return launch<S, 2 * G>(p, bsz, stream);
  }
  if (G * S < p.ds) return (int)cudaErrorInvalidValue;
  constexpr int kCh = kThreads / G;
  const dim3 grid((p.di + kCh - 1) / kCh, bsz);
  scan_kernel<S, G><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" int mamba_scan(const float* x, const float* dt, const float* b_in,
                          const float* c_in, const float* a, const float* h0,
                          float* y, float* h_out, int bsz, int s_pad, int di,
                          int ds, cudaStream_t stream) {
  if (bsz < 1 || s_pad < 1 || di < 1 || ds < 1 || ds > kMaxState) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = di % 4 == 0 && ds % 4 == 0 && aligned16(x) && aligned16(dt) &&
                   aligned16(b_in) && aligned16(c_in) && aligned16(a) && aligned16(h0) &&
                   aligned16(h_out);
  const Params p{x, dt, b_in, c_in, a, h0, y, h_out, s_pad, di, ds, vec};
  return launch<kStatesPerLane>(p, bsz, stream);
}

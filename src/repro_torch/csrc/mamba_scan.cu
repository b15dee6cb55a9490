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
// moves inside the block.  One thread owns one channel and keeps its ds
// states and its row of A in registers (ds <= 64; a template on the
// register count, 16 / 32 / 64).  A block covers kThreads channels of one
// batch row: grid (ceil(di / kThreads), b), 256 blocks at falcon decode
// (b = 4, di = 8192).  Positions go in chunks of kSteps: the block stages
// the chunk's B and C (ds values per position, shared by all channels) in
// shared memory, and each thread loads its chunk of x and dt into
// registers first (coalesced across channels; all loads in flight before
// the recurrence needs them).  y is summed over ds inside the thread in
// index order; exp is expf (not __expf), so a step agrees with the plain
// version to about one rounding (the compiler may fuse the multiply-add).
// The final state is written once.
//
// What bounds it.  Bytes: at falcon decode (b = 4, s_pad = 16, di = 8192,
// ds = 16) x, dt, y, A, h0 and h come to ~11 MB, 3.3 us at 3.35 TB/s;
// the 8.4 M expf and 50 MFLOP are of the same order on the SFUs and the
// f32 pipes.  Left for later: a chunk-parallel scan over positions for
// long prefills (the loop over s_pad is sequential per thread), and
// overlap of the next chunk's loads with this chunk's recurrence.
//
// Accepted inputs: f32, contiguous, 1 <= ds <= 64, di >= 1, s_pad >= 1.
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;   // channels of one block
constexpr int kSteps = 16;      // positions staged at once (SSM_CHUNK)

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
};

template <int DS>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const Params p) {
  __shared__ float sb[kSteps][DS];
  __shared__ float sc[kSteps][DS];
  const int row = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < p.di;
  const int ds = p.ds;

  float h[DS], av[DS];
  const size_t state = ((size_t)row * p.di + (live ? d : 0)) * ds;
#pragma unroll
  for (int j = 0; j < DS; ++j) {
    const bool on = live && j < ds;
    h[j] = on ? p.h0[state + j] : 0.f;
    av[j] = on ? p.a[(size_t)d * ds + j] : 0.f;
  }

  const size_t seq = (size_t)row * p.s_pad;
  for (int t0 = 0; t0 < p.s_pad; t0 += kSteps) {
    const int steps = min(kSteps, p.s_pad - t0);
    __syncthreads();                 // the previous chunk's reads are done
    for (int i = threadIdx.x; i < steps * ds; i += kThreads) {
      const int tt = i / ds, j = i - tt * ds;
      sb[tt][j] = p.b_in[(seq + t0 + tt) * ds + j];
      sc[tt][j] = p.c_in[(seq + t0 + tt) * ds + j];
    }
    float xv[kSteps], dv[kSteps];
#pragma unroll
    for (int tt = 0; tt < kSteps; ++tt) {
      const bool on = live && tt < steps;
      const size_t off = (seq + t0 + tt) * p.di + d;
      xv[tt] = on ? p.x[off] : 0.f;
      dv[tt] = on ? p.dt[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kSteps; ++tt) {
      if (tt < steps) {              // the same for every thread
        const float dtx = dv[tt] * xv[tt];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < DS; ++j) {
          if (j < ds) {
            const float da = expf(dv[tt] * av[j]);
            h[j] = da * h[j] + dtx * sb[tt][j];
            acc += h[j] * sc[tt][j];
          }
        }
        if (live) p.y[(seq + t0 + tt) * p.di + d] = acc;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < DS; ++j) {
      if (j < ds) p.h_out[state + j] = h[j];
    }
  }
}

}  // namespace

extern "C" int mamba_scan(const float* x, const float* dt, const float* b_in,
                          const float* c_in, const float* a, const float* h0,
                          float* y, float* h_out, int bsz, int s_pad, int di,
                          int ds, cudaStream_t stream) {
  if (bsz < 1 || s_pad < 1 || di < 1 || ds < 1 || ds > 64) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{x, dt, b_in, c_in, a, h0, y, h_out, s_pad, di, ds};
  const dim3 grid((di + kThreads - 1) / kThreads, bsz);
  if (ds <= 16) {
    scan_kernel<16><<<grid, kThreads, 0, stream>>>(p);
  } else if (ds <= 32) {
    scan_kernel<32><<<grid, kThreads, 0, stream>>>(p);
  } else {
    scan_kernel<64><<<grid, kThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

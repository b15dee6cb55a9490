// Fused grouped expert FFN (MoE) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/moe_ffn/kernel.py: moe_ffn_pallas (body _moe_kernel).
//
// What it computes.  Token rows sorted by expert are padded per expert to
// token_block rows (kernels/moe_ffn/ops.py align_block_size); block i of
// the padded layout belongs to expert block_expert[i] and is executed only
// if block_valid[i] (the TPU's @pl.when(valid)).  For each row x of a valid
// block, with that expert's weights,
//   h   = silu(x·Wg) ∘ (x·Wu)      (swiglu)   or   gelu_tanh(x·Wu)   (gelu)
//   out = h·Wd
// with f32 accumulation and a bf16 output.  The Pallas kernel casts x and
// the weights to f32 and keeps h in f32 between the two projections.
//
// What bounds it on this card.  At decode (T = 4 tokens of granite: 32
// routed rows, about one per expert, padded to 16-row blocks) the least
// time is the active experts' weight bytes over 3.35 TB/s; each byte has
// to be requested early enough, about 25 KB in flight per SM by Little's
// law at a microsecond of loaded latency.  At prefill (T = 256, 64-row
// blocks) the same bytes meet 2·3·rows·d·f products: on f32 CUDA cores
// (67 TFLOP/s) several times the byte time, on the bf16 tensor cores
// about a third of it.
//
// Design.  Two launches with h in global scratch, as the TPU's sequential
// f axis has no counterpart among blocks that run in no order:
//   phase A, grid (64-column slice of f, token block):
//     h[rows, slice] = act(x[rows]·Wg[:, slice], x[rows]·Wu[:, slice])
//   phase B, grid (128-column slice of d, token block):
//     out[rows, slice] = h[rows]·Wd[:, slice]
// Column slices are the fastest grid axis, so the blocks resident together
// read whole rows of one expert's weights.  A thread block (4 warps)
// holds one token block of 16 or 64 rows (a larger block is walked in
// pieces of at most 64 rows) and walks the reduction in steps of 64.  Each
// step's operands — the 16..64 input rows and the 64-row tile of each
// weight matrix — are copied by 16-byte cp.async.cg into a ring of three
// shared-memory stages, two steps ahead of the step being multiplied, with
// one barrier per step.  Three stages rather than more keep a 64-row
// block's ring at 72 KB, so three blocks fit an SM and a prefill's phase A
// runs in one wave.  Staged rows are lines whose 16-byte chunks are
// XOR-swizzled by the line index within each 128 bytes, so ldmatrix reads
// them without bank conflicts.  Each warp owns a quarter of the columns and
// issues mma.sync.m16n8k16 (bf16 in, f32 accumulation in registers) for
// every 16-row m-tile: products of bf16 values are exact in f32, so phase
// A matches the Pallas kernel's f32 dots up to summation order.  mma.sync
// rather than wgmma: one token block is 16 rows at decode and a 64-row
// wgmma tile would either waste 48 rows or take the weights as its M side
// with a transposed, swizzled shared layout; mma.sync keeps every row on
// the same per-16-row path at both block sizes.
//
// f32 h through bf16 tensor cores.  Phase A writes h as two bf16 planes,
// hi = bf16(h) and lo = bf16(h - hi): the 4 bytes per element of an f32
// scratch.  Phase B issues two products per reduction step, hi·Wd and then
// lo·Wd, into one f32 accumulator.  |h - hi - lo| <= 2^-16 |h| (two
// roundings of 2^-8 relative each), so against the Pallas kernel's f32 h
// this adds about 2^-16 of |h| per element before the sum, far inside the
// one bf16 rounding of the output.  TF32 would keep only 10 bits of h.
//
// Row invariance.  A row's sums run over the reduction in steps of 64 and,
// within a step, in four k16 products (phase B: hi then lo for each), an
// order fixed by d and f alone; an mma.sync output row depends only on its
// own A row.  So a row gives bitwise the same output at token_block 16 and
// 64, and padding rows (computed, as on the TPU: the M_moe staircase is
// real work) cannot leak into valid ones.
//
// The gap between the launches.  Phase B is launched as a programmatic
// dependent of phase A: its blocks start while phase A's last blocks run,
// request their first Wd tiles, and wait for phase A's h only before
// requesting their inputs.
//
// Invalid blocks exit at once, so the grid covers the static bound m_pad
// and no host sync sizes it; an optional counter adds one per valid token
// block executed.
//
// Accepted inputs: bf16 x and weights, swiglu or gelu, d % 8 == 0,
// f % 8 == 0 and (f <= 512 or f % 512 == 0), token_block a multiple of 16
// dividing m_pad, contiguous 16-byte-aligned tensors.  The C entry point
// returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kThreads = 128;
constexpr int kMaxRows = 64;   // rows of one thread block: four 16-row m-tiles
constexpr int kMaxTiles = kMaxRows / 16;
constexpr int kColsUp = 64;    // output columns of one phase-A thread block, a quarter per warp
constexpr int kColsDown = 128; // of one phase-B thread block
constexpr int kDepth = 64;     // reduction steps of one pipeline stage
constexpr int kLine = kDepth * 2;  // bytes of one staged input row
constexpr int kStages = 3;

struct Params {
  const __nv_bfloat16* x;       // (m_pad, d)
  const __nv_bfloat16* w_gate;  // (E, d, f), null for gelu
  const __nv_bfloat16* w_up;    // (E, d, f)
  const __nv_bfloat16* w_down;  // (E, f, d)
  const int* block_expert;      // (m_pad / token_block,)
  const int* block_valid;
  __nv_bfloat16* h;             // (2, m_pad, f): the hi plane, then the lo plane
  __nv_bfloat16* out;           // (m_pad, d)
  int* blocks;                  // optional: += 1 per valid block executed
  int m_pad, d, f, token_block;
  int rows;                     // rows of one thread block: 16, 32, 48 or 64
};

__device__ inline float silu(float v) { return v / (1.f + expf(-v)); }

__device__ inline float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

// 16-byte chunk c of a staged line of `bytes` bytes, XOR-swizzled by the
// line index within each 128-byte group
__device__ inline uint32_t swz(int line, int c, int bytes) {
  return (uint32_t)(line * bytes + ((c ^ (line & 7)) << 4));
}

// One thread block's tile of sum_p A_p[rows]·B_m over depth K, for kPlanes
// row-major (m_pad, K) input planes A_p (a0, a1) and kMats row-major (K, N)
// weight matrices B_m (b0, b1), kCols columns from col0, into
// acc[m-tile][matrix][n8 tile][4] (the warp's kCols/4 columns, mma.sync C
// layout).  A stage holds kPlanes·rows input lines of kDepth bf16, then
// kMats·kDepth weight lines of kCols bf16.
// kAfterPrimary: the kernel is launched dependent on the one before it
// (programmatic dependent launch); the weight tiles of the first stages are
// requested before waiting for that kernel's writes, the inputs after.
template <int kPlanes, int kMats, int kCols, bool kAfterPrimary = false>
__device__ inline void tile_product(const __nv_bfloat16* a0, const __nv_bfloat16* a1,
                                    const __nv_bfloat16* b0, const __nv_bfloat16* b1, int K,
                                    int N, int row0, int rows, int col0, uint8_t* smem,
                                    float (&acc)[kMaxTiles][kMats][kCols / 32][4]) {
  constexpr int kNt = kCols / 32, kWLine = kCols * 2, kWChunks = kCols / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int a_lines = kPlanes * rows;
  const uint32_t a_bytes = (uint32_t)a_lines * kLine;
  const uint32_t stage_bytes = a_bytes + (uint32_t)kMats * kDepth * kWLine;
  const uint32_t base = smem_addr(smem);
  const int mt = rows >> 4;
  const int steps = (K + kDepth - 1) / kDepth;

#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
    for (int m = 0; m < kMats; ++m)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][m][j][e] = 0.f;

  auto load_a = [&](int step) {
    const int k0 = step * kDepth;
    const uint32_t st = base + (uint32_t)(step % kStages) * stage_bytes;
    for (int idx = tid; idx < a_lines * (kDepth / 8); idx += kThreads) {
      const int line = idx / (kDepth / 8), c = idx % (kDepth / 8);
      const bool second = kPlanes == 2 && line >= rows;
      const int r = second ? line - rows : line;
      const bool ok = k0 + c * 8 < K;
      const __nv_bfloat16* src = (second ? a1 : a0) + (size_t)(row0 + r) * K + k0 + c * 8;
      cp_async16(st + swz(line, c, kLine), ok ? src : a0, ok);
    }
  };
  auto load_w = [&](int step) {
    const int k0 = step * kDepth;
    const uint32_t st = base + (uint32_t)(step % kStages) * stage_bytes;
    for (int idx = tid; idx < kMats * kDepth * kWChunks; idx += kThreads) {
      const int line = idx / kWChunks, c = idx - line * kWChunks;
      const bool second = kMats == 2 && line >= kDepth;
      const int kr = second ? line - kDepth : line;
      const bool ok = k0 + kr < K && col0 + c * 8 < N;
      const __nv_bfloat16* src = (second ? b1 : b0) + (size_t)(k0 + kr) * N + col0 + c * 8;
      cp_async16(st + a_bytes + swz(line, c, kWLine), ok ? src : b0, ok);
    }
  };

  if constexpr (kAfterPrimary) {
    for (int s = 0; s < kStages - 1; ++s)
      if (s < steps) load_w(s);
    wait_for_primary();
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load_a(s);
      cp_async_commit();
    }
  } else {
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) { load_a(s); load_w(s); }
      cp_async_commit();
    }
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step has landed; the stage refilled next is consumed
    if (step + kStages - 1 < steps) { load_a(step + kStages - 1); load_w(step + kStages - 1); }
    cp_async_commit();
    const uint32_t st = base + (uint32_t)(step % kStages) * stage_bytes;
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      // weights: k rows ks*16 .. +15, this warp's columns, 16 per ldmatrix
      uint32_t bf[kMats][kNt / 2][4];
      const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int m = 0; m < kMats; ++m)
#pragma unroll
        for (int jp = 0; jp < kNt / 2; ++jp)
          ldsm_x4_trans(bf[m][jp], st + a_bytes +
                                       swz(m * kDepth + kr, warp * kNt + 2 * jp + (lane >> 4), kWLine));
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i) {
        if (i >= mt) break;
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          uint32_t af[4];
          ldsm_x4(af, st + swz(pl * rows + i * 16 + (lane & 15), ks * 2 + (lane >> 4), kLine));
#pragma unroll
          for (int m = 0; m < kMats; ++m)
#pragma unroll
            for (int j = 0; j < kNt; ++j)
              mma16816(acc[i][m][j], af, bf[m][j / 2][(j & 1) * 2], bf[m][j / 2][(j & 1) * 2 + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Grid: x = column slice, y = row piece.  Slices run fastest, so the
// blocks resident together read whole rows of one expert's weights.
__device__ inline int slice() { return blockIdx.x; }
__device__ inline int piece() { return blockIdx.y; }

__device__ inline bool block_of(const Params& p, int* expert) {
  const int blk = piece() * p.rows / p.token_block;
  if (!p.block_valid[blk]) return false;
  *expert = p.block_expert[blk];
  return true;
}

// the stage ring of a thread block of `rows` rows
constexpr size_t smem_bytes(int a_lines, int mats, int cols) {
  return (size_t)kStages * ((size_t)a_lines * kLine + (size_t)mats * kDepth * cols * 2);
}

template <bool kGated>
__global__ void __launch_bounds__(kThreads, 2) up_kernel(Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kMats = kGated ? 2 : 1;
  allow_dependents();
  int e;
  if (!block_of(p, &e)) return;
  const int row0 = piece() * p.rows, col0 = slice() * kColsUp;
  if (p.blocks != nullptr && slice() == 0 && row0 % p.token_block == 0 && threadIdx.x == 0)
    atomicAdd(p.blocks, 1);
  const size_t woff = (size_t)e * p.d * p.f;
  // gated: (Wg, Wu); gelu: (Wu)
  const __nv_bfloat16* w0 = (kGated ? p.w_gate : p.w_up) + woff;
  float acc[kMaxTiles][kMats][kColsUp / 32][4];
  tile_product<1, kMats, kColsUp>(p.x, nullptr, w0, p.w_up + woff, p.d, p.f, row0, p.rows, col0, smem,
                         acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* hi = p.h;
  __nv_bfloat16* lo = p.h + (size_t)p.m_pad * p.f;
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    if (i * 16 >= p.rows) break;
#pragma unroll
    for (int j = 0; j < kColsUp / 32; ++j) {
      const int col = col0 + warp * (kColsUp / 4) + j * 8 + (lane & 3) * 2;
      if (col >= p.f) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + i * 16 + (lane >> 2) + half * 8;
        float hv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float up = acc[i][kMats - 1][j][half * 2 + c];
          hv[c] = kGated ? silu(acc[i][0][j][half * 2 + c]) * up : gelu_tanh(up);
        }
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(hv[0], hv[1]);
        const float2 back = __bfloat1622float2(h2);
        const size_t off = (size_t)row * p.f + col;
        *reinterpret_cast<__nv_bfloat162*>(hi + off) = h2;
        *reinterpret_cast<__nv_bfloat162*>(lo + off) =
            __floats2bfloat162_rn(hv[0] - back.x, hv[1] - back.y);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) down_kernel(Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  int e;
  if (!block_of(p, &e)) return;
  const int row0 = piece() * p.rows, col0 = slice() * kColsDown;
  float acc[kMaxTiles][1][kColsDown / 32][4];
  tile_product<2, 1, kColsDown, true>(p.h, p.h + (size_t)p.m_pad * p.f, p.w_down + (size_t)e * p.f * p.d, nullptr,
                     p.f, p.d, row0, p.rows, col0, smem, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    if (i * 16 >= p.rows) break;
#pragma unroll
    for (int j = 0; j < kColsDown / 32; ++j) {
      const int col = col0 + warp * (kColsDown / 4) + j * 8 + (lane & 3) * 2;
      if (col >= p.d) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + i * 16 + (lane >> 2) + half * 8;
        *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)row * p.d + col) =
            __floats2bfloat162_rn(acc[i][0][j][half * 2], acc[i][0][j][half * 2 + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *done = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" int moe_ffn(const void* x, const void* w_gate, const void* w_up, const void* w_down,
                       const void* block_expert, const void* block_valid, void* h, void* out,
                       int m_pad, int d, int f, int token_block, int gated, void* blocks,
                       void* stream) {
  if (d % 8 != 0 || f % 8 != 0 || (f > 512 && f % 512 != 0) || token_block < 16 ||
      token_block % 16 != 0 || m_pad % token_block != 0 || (gated && w_gate == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w_gate = static_cast<const __nv_bfloat16*>(w_gate);
  p.w_up = static_cast<const __nv_bfloat16*>(w_up);
  p.w_down = static_cast<const __nv_bfloat16*>(w_down);
  p.block_expert = static_cast<const int*>(block_expert);
  p.block_valid = static_cast<const int*>(block_valid);
  p.h = static_cast<__nv_bfloat16*>(h);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.blocks = static_cast<int*>(blocks);
  p.m_pad = m_pad; p.d = d; p.f = f; p.token_block = token_block;
  p.rows = 16;  // the largest of 64, 48, 32, 16 that divides the token block
  for (int r = kMaxRows; r > 16; r -= 16) {
    if (token_block % r == 0) {
      p.rows = r;
      break;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // opt in once to the largest stage ring (64 rows) of each kernel
  static bool up_gated_ok = false, up_plain_ok = false, down_ok = false;
  cudaError_t e = gated ? allow_smem(up_kernel<true>, smem_bytes(kMaxRows, 2, kColsUp), &up_gated_ok)
                        : allow_smem(up_kernel<false>, smem_bytes(kMaxRows, 1, kColsUp), &up_plain_ok);
  if (e == cudaSuccess) e = allow_smem(down_kernel, smem_bytes(2 * kMaxRows, 1, kColsDown), &down_ok);
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_a((f + kColsUp - 1) / kColsUp, m_pad / p.rows);
  const size_t up_smem = smem_bytes(p.rows, gated ? 2 : 1, kColsUp);
  if (gated) {
    up_kernel<true><<<grid_a, kThreads, up_smem, s>>>(p);
  } else {
    up_kernel<false><<<grid_a, kThreads, up_smem, s>>>(p);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_b((d + kColsDown - 1) / kColsDown, m_pad / p.rows);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid_b;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(2 * p.rows, 1, kColsDown);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, down_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

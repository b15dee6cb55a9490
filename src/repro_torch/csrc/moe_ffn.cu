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
// with f32 products, f32 h, f32 accumulation and a bf16 output — as the
// Pallas kernel, which keeps h in f32 between the two projections.
//
// Design.  The TPU kernel walks f tiles sequentially and accumulates the
// output in VMEM; CUDA blocks run in no order, so the work splits into two
// launches with h in a global f32 scratch (m_pad, f):
//   phase A, grid (16-row sub-block, 64-column slice of f):
//     h[rows, slice] = act(x[rows]·Wg[:, slice], x[rows]·Wu[:, slice])
//   phase B, grid (16-row sub-block, 64-column slice of d):
//     out[rows, slice] = h[rows]·Wd[:, slice]
// The grid covers all m_pad / 16 sub-blocks of the static bound; a
// sub-block of an invalid block exits at once, so no host sync sizes the
// grid.  Each thread block stages its 16 input rows in shared memory, 512
// reduction steps (the f tile) at a time, transposed to f32 so one step
// reads all 16 rows as four 16-byte broadcasts.  Each warp owns one eighth
// of the reduction and each lane two adjacent output columns, whose weights
// it streams straight from device memory (a warp reads 128 contiguous
// bytes per step); the eight warps' partial sums are added in warp order
// through shared memory.  No atomics: phase B reduces over all of f inside
// one thread block.  f32 math on CUDA cores, because a bf16 tensor-core
// product would round h.
//
// Row invariance.  A row's sums run in an order fixed by d and f alone
// (chunk of 512, warp slice, step), never by the block it sits in, its
// position there or the other rows: a row gives bitwise the same output at
// token_block 16 and 64, and padding rows cannot leak into valid ones.
//
// What bounds it.  At decode (a few tokens, ~1 row per expert) the least
// time is the active experts' weight bytes over 3.35 TB/s; each weight
// byte is read once per 16-row sub-block (more than once only within a
// 64-row block, from L2).  At prefill the 2·3·rows·d·f products bound it,
// and on CUDA cores this design sits far above the tensor-core bound.
// Left for later: no TMA, no wgmma, no overlap of loads with math beyond
// what the unrolled loop gives, and padding rows are computed (the
// M_moe staircase is real work here, as on the TPU).
//
// Accepted inputs: bf16 x and weights, swiglu or gelu, d % 8 == 0,
// f % 8 == 0 and (f <= 512 or f % 512 == 0), token_block a multiple of 16
// dividing m_pad, contiguous 16-byte-aligned tensors.  The C entry point
// returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;     // rows of one sub-block
constexpr int kCols = 64;     // output columns of one thread block: 2 per lane
constexpr int kChunk = 512;   // reduction steps staged at once (the f tile)
constexpr int kUnroll = 8;    // weight loads kept in flight per lane

struct Params {
  const __nv_bfloat16* x;       // (m_pad, d)
  const __nv_bfloat16* w_gate;  // (E, d, f), null for gelu
  const __nv_bfloat16* w_up;    // (E, d, f)
  const __nv_bfloat16* w_down;  // (E, f, d)
  const int* block_expert;      // (m_pad / token_block,)
  const int* block_valid;
  float* h;                     // (m_pad, f) scratch
  __nv_bfloat16* out;           // (m_pad, d)
  int* blocks;                  // optional: += 1 per valid block executed
  int m_pad, d, f, token_block;
};

__device__ inline float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ inline float silu(float v) { return v / (1.f + expf(-v)); }

__device__ inline float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

// Stage rows [row0, row0 + 16) x steps [k0, k0 + kc) of a row-major
// (rows, ld) input into xs[step * 16 + row] as f32; kc is even.
__device__ inline void stage(const __nv_bfloat16* in, int ld, int row0, int k0, int kc,
                            float* xs) {
  const int pairs = kc / 2;
  for (int idx = threadIdx.x; idx < kRows * pairs; idx += kThreads) {
    const int r = idx % kRows, kp = idx / kRows;
    const uint32_t w =
        reinterpret_cast<const uint32_t*>(in + (size_t)(row0 + r) * ld + k0)[kp];
    const float2 v = bf2_to_f2(w);
    xs[(2 * kp) * kRows + r] = v.x;
    xs[(2 * kp + 1) * kRows + r] = v.y;
  }
}

__device__ inline void stage(const float* in, int ld, int row0, int k0, int kc, float* xs) {
  const int pairs = kc / 2;
  for (int idx = threadIdx.x; idx < kRows * pairs; idx += kThreads) {
    const int r = idx % kRows, kp = idx / kRows;
    const float2 v = reinterpret_cast<const float2*>(in + (size_t)(row0 + r) * ld + k0)[kp];
    xs[(2 * kp) * kRows + r] = v.x;
    xs[(2 * kp + 1) * kRows + r] = v.y;
  }
}

// acc[m][r][c] += sum over this warp's slice of the staged steps of
// xs[step][r] * W_m[k0 + step][col + c], in step order.
template <int kMats>
__device__ inline void accumulate(const float* xs, int kb, int kw,
                                  const __nv_bfloat16* const* w, int ldw, bool col_ok,
                                  float (&acc)[kMats][kRows][2]) {
  for (int k = 0; k < kw; k += kUnroll) {
    uint32_t wv[kMats][kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        wv[m][i] = (col_ok && k + i < kw)
                       ? __ldg(reinterpret_cast<const uint32_t*>(w[m] + (size_t)(k + i) * ldw))
                       : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (k + i >= kw) break;
      const float4* xv = reinterpret_cast<const float4*>(xs + (kb + k + i) * kRows);
      float xr[kRows];
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 v = xv[q];
        xr[4 * q] = v.x;
        xr[4 * q + 1] = v.y;
        xr[4 * q + 2] = v.z;
        xr[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float2 wf = bf2_to_f2(wv[m][i]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[m][r][0] = fmaf(xr[r], wf.x, acc[m][r][0]);
          acc[m][r][1] = fmaf(xr[r], wf.y, acc[m][r][1]);
        }
      }
    }
  }
}

// One 16-row x 64-column output tile of in[rows] · W_m over depth K, for
// kMats weight matrices sharing the input.  Leaves the warp-ordered sums in
// red[m][r][c] (shared memory).  in: (m_pad, K) of type T; W_m: (K, N).
template <int kMats, typename T>
__device__ inline void tile_product(const T* in, int K, const __nv_bfloat16* const* w_base,
                                    int N, int row0, int col0, float* xs, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = col0 + 2 * lane;
  const bool col_ok = col < N;
  float acc[kMats][kRows][2];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[m][r][0] = acc[m][r][1] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    const int kw = kc / kWarps, kb = warp * kw;
    __syncthreads();  // the previous chunk is consumed
    stage(in, K, row0, k0, kc, xs);
    __syncthreads();
    const __nv_bfloat16* w[kMats];
#pragma unroll
    for (int m = 0; m < kMats; ++m) w[m] = w_base[m] + (size_t)(k0 + kb) * N + col;
    accumulate<kMats>(xs, kb, kw, w, N, col_ok, acc);
  }

  // partial sums of the eight warps -> red, added in warp order
  float* part = xs + kChunk * kRows;  // (kMats, kWarps, kRows, kCols)
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float* dst = part + ((m * kWarps + warp) * kRows + r) * kCols + 2 * lane;
      dst[0] = acc[m][r][0];
      dst[1] = acc[m][r][1];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kMats * kRows * kCols; idx += kThreads) {
    const int m = idx / (kRows * kCols), rc = idx - m * kRows * kCols;
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += part[(m * kWarps + wi) * kRows * kCols + rc];
    red[idx] = s;
  }
  __syncthreads();
}

__device__ inline bool block_of(const Params& p, int* expert) {
  const int blk = blockIdx.x * kRows / p.token_block;
  if (!p.block_valid[blk]) return false;
  *expert = p.block_expert[blk];
  return true;
}

// shared memory: staged rows | warp partials | reduced tile
constexpr size_t smem_bytes(int mats) {
  return sizeof(float) * ((size_t)kChunk * kRows + (size_t)mats * (kWarps + 1) * kRows * kCols);
}

template <bool kGated>
__global__ void __launch_bounds__(kThreads, 2) up_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int kMats = kGated ? 2 : 1;
  int e;
  if (!block_of(p, &e)) return;
  const int row0 = blockIdx.x * kRows, col0 = blockIdx.y * kCols;
  if (p.blocks != nullptr && blockIdx.y == 0 && row0 % p.token_block == 0 && threadIdx.x == 0)
    atomicAdd(p.blocks, 1);
  const size_t woff = (size_t)e * p.d * p.f;
  const __nv_bfloat16* w[kMats];
  if constexpr (kGated) {
    w[0] = p.w_gate + woff;
    w[1] = p.w_up + woff;
  } else {
    w[0] = p.w_up + woff;
  }
  float* red = smem + kChunk * kRows + kMats * kWarps * kRows * kCols;
  tile_product<kMats>(p.x, p.d, w, p.f, row0, col0, smem, red);
  for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx - r * kCols;
    if (col0 + c >= p.f) continue;
    const float up = red[(kMats - 1) * kRows * kCols + idx];
    const float hv = kGated ? silu(red[idx]) * up : gelu_tanh(up);
    p.h[(size_t)(row0 + r) * p.f + col0 + c] = hv;
  }
}

__global__ void __launch_bounds__(kThreads, 2) down_kernel(Params p) {
  extern __shared__ float smem[];
  int e;
  if (!block_of(p, &e)) return;
  const int row0 = blockIdx.x * kRows, col0 = blockIdx.y * kCols;
  const __nv_bfloat16* w[1] = {p.w_down + (size_t)e * p.f * p.d};
  float* red = smem + kChunk * kRows + kWarps * kRows * kCols;
  tile_product<1>(p.h, p.f, w, p.d, row0, col0, smem, red);
  for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx - r * kCols;
    if (col0 + c >= p.d) continue;
    p.out[(size_t)(row0 + r) * p.d + col0 + c] = __float2bfloat16_rn(red[idx]);
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
  if (d % 8 != 0 || f % 8 != 0 || (f > kChunk && f % kChunk != 0) || token_block < kRows ||
      token_block % kRows != 0 || m_pad % token_block != 0 || (gated && w_gate == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w_gate = static_cast<const __nv_bfloat16*>(w_gate);
  p.w_up = static_cast<const __nv_bfloat16*>(w_up);
  p.w_down = static_cast<const __nv_bfloat16*>(w_down);
  p.block_expert = static_cast<const int*>(block_expert);
  p.block_valid = static_cast<const int*>(block_valid);
  p.h = static_cast<float*>(h);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.blocks = static_cast<int*>(blocks);
  p.m_pad = m_pad; p.d = d; p.f = f; p.token_block = token_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  static bool up_gated_ok = false, up_plain_ok = false, down_ok = false;
  const size_t up_smem = smem_bytes(gated ? 2 : 1), down_smem = smem_bytes(1);
  cudaError_t e = gated ? allow_smem(up_kernel<true>, up_smem, &up_gated_ok)
                        : allow_smem(up_kernel<false>, up_smem, &up_plain_ok);
  if (e == cudaSuccess) e = allow_smem(down_kernel, down_smem, &down_ok);
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_a(m_pad / kRows, (f + kCols - 1) / kCols);
  if (gated) {
    up_kernel<true><<<grid_a, kThreads, up_smem, s>>>(p);
  } else {
    up_kernel<false><<<grid_a, kThreads, up_smem, s>>>(p);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_b(m_pad / kRows, (d + kCols - 1) / kCols);
  down_kernel<<<grid_b, kThreads, down_smem, s>>>(p);
  return (int)cudaGetLastError();
}

// Multi-position decode attention for Hopper (sm_90a), two addressing modes.
//
// Replaces the Pallas TPU kernels of the reference package,
// src/repro/kernels/decode_attention/kernel.py: decode_attention_pallas
// (dense per-slot cache) and decode_attention_paged_pallas (global paged
// pool + block tables).  Both share the Pallas body _attn_kernel; here
// both share attn_kernel<kPaged>.
//
// What it computes.  For batch row b, the n new query positions sit at
// logical positions len_b .. len_b+n-1 (their K/V already written to the
// cache).  Each query row attends causally (optionally within a sliding
// window) over its row's cache: f32 scores, f32 online softmax, f32
// accumulation, bf16 output.  GQA: the g query heads of one kv head are
// folded into the rows of one block, as the Pallas kernel folds them
// into M = g*q_block.
//
// Grid.  One block per (q tile, kv head, batch row).  The q tile is
// select_q_block(n, dh) of the port's core/granularity.py, so the NFP
// predictor and this launch read the same M_attn.  Padded rows of the
// last q tile (query index >= n) are SKIPPED: they are neither loaded,
// computed nor stored; the tile quantization shows in the number of
// blocks, not in wasted row work.
//
// The kv loop is the TPU's sequential grid axis.  Its bounds are the
// Pallas skip rule (kernel.py:70-77) turned into loop limits:
//   hi_tile = min(n_kv_tiles, cdiv(len_b + min(n, (iq+1)*q_block), k_block))
//   lo_tile = window ? max(0, floor((len_b + iq*q_block - window + 1) / k_block)) : 0
// so a block executes exactly the tiles ops.slack_report counts as
// kv_tiles_executed (an optional device counter adds them up).
//
// Per tile.  One K and one V tile (k_block x dh bf16: a 16-position
// page, or the 128-position dense tile) are staged in shared memory, the
// scores of up to 64 resident query rows are computed and masked in
// logical positions (kernel.py:93-113), the online-softmax state is
// updated, and the f32 accumulators in shared memory absorb P·V.  An
// empty row (l == 0) outputs 0.  Blocks with more than 64 valid rows
// (GQA with g*n > 64) walk their rows in chunks of 64, re-reading K/V.
//
// What bounds it.  Decode attention is memory-bound on this card: the
// least time is the K/V bytes of the executed tiles (plus q and o) over
// 3.35 TB/s.  The design keeps every K/V byte to one read from device
// memory per block (staged once per tile, reused by all resident rows of
// the block, 16-byte vector loads), skips tiles outside the rows' range
// instead of masking them, and never materializes the scores outside
// shared memory.  It does not yet overlap the next tile's loads with the
// current tile's math (no cp.async/TMA pipeline) and computes on CUDA
// cores, not tensor cores: work for a later change.
//
// Accepted inputs: bf16 q/k/v, dh % 16 == 0 and dh <= 128, k_block <= 128,
// contiguous tensors, 16-byte-aligned bases.  The C entry points return
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowChunk = 64;  // query rows resident in shared memory at once
constexpr int kMaxDh = 128;
constexpr int kMaxKBlock = 128;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

struct Params {
  const __nv_bfloat16* q;  // (b, n, h, dh)
  const __nv_bfloat16* k;  // dense (b, s_max, kv, dh) | paged (n_phys, k_block, kv, dh)
  const __nv_bfloat16* v;
  __nv_bfloat16* o;        // (b, n, h, dh)
  const int* lens;         // (b,) committed positions per row
  const int* tables;       // paged: (b, max_blocks) logical tile -> physical page
  int* tiles;              // optional: += kv tiles executed per block
  int b, n, h, kv, g, dh;
  int q_block, k_block, n_kv_tiles;
  int s_max;               // dense: positions per cache row
  int max_blocks;          // paged: table width
  int window;              // < 0: no window
  int row_chunk;           // resident rows (<= kRowChunk)
  float scale;
};

__host__ __device__ inline int align4(int words) { return (words + 3) & ~3; }

// Shared-memory layout in 32-bit words.  bf16 rows are stored as bf16x2
// words with a row stride of dh/2 + 1 (odd), so threads reading different
// rows at the same column hit different banks.
struct Layout {
  int wpr, q, k, v, s, acc, m, l, alpha, total;
  __host__ __device__ Layout(int row_chunk, int k_block, int dh) {
    wpr = dh / 2 + 1;
    q = 0;
    k = q + align4(row_chunk * wpr);
    v = k + align4(k_block * wpr);
    s = v + align4(k_block * wpr);
    acc = s + align4(row_chunk * k_block);
    m = acc + align4(row_chunk * dh);
    l = m + align4(row_chunk);
    alpha = l + align4(row_chunk);
    total = alpha + align4(row_chunk);
  }
};

__device__ inline float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ inline uint32_t f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool kPaged>
__global__ void __launch_bounds__(kThreads) attn_kernel(Params p) {
  extern __shared__ uint32_t smem[];
  const int iq = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = p.k_block, dh = p.dh, hw = dh / 2, vec = dh / 8;
  const Layout L(p.row_chunk, kb, dh);
  uint32_t* q_s = smem + L.q;
  uint32_t* k_s = smem + L.k;
  uint32_t* v_s = smem + L.v;
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* a_s = reinterpret_cast<float*>(smem + L.alpha);

  const int len = p.lens[bi];
  const int q0 = iq * p.q_block;             // first query index of this q tile
  const int nq = min(p.q_block, p.n - q0);   // valid query rows per head
  const int rows = p.g * nq;                 // valid rows of the block

  // the Pallas skip rule as loop bounds
  const int hi = len + min(p.n, q0 + p.q_block);
  const int hi_tile = min(p.n_kv_tiles, (hi + kb - 1) / kb);
  int lo_tile = 0;
  if (p.window >= 0) {
    const int lo_visible = len + q0 - p.window + 1;
    lo_tile = lo_visible > 0 ? lo_visible / kb : 0;
  }
  if (p.tiles != nullptr && tid == 0) atomicAdd(p.tiles, max(0, hi_tile - lo_tile));

  for (int c0 = 0; c0 < rows; c0 += p.row_chunk) {
    const int R = min(p.row_chunk, rows - c0);
    // ---- resident query rows (row = gi*nq + qi, the Pallas g*q_block fold)
    for (int idx = tid; idx < R * hw; idx += kThreads) {
      const int r = idx / hw, w = idx - r * hw;
      const int row = c0 + r, gi = row / nq, qi = row - gi * nq;
      const size_t off = ((size_t)(bi * p.n + q0 + qi) * p.h + kh * p.g + gi) * dh;
      q_s[r * L.wpr + w] = reinterpret_cast<const uint32_t*>(p.q + off)[w];
    }
    for (int r = tid; r < R; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }
    for (int idx = tid; idx < R * dh; idx += kThreads) acc[idx] = 0.f;
    __syncthreads();

    for (int tile = lo_tile; tile < hi_tile; ++tile) {
      // ---- stage one K and one V tile (16-byte loads, zero past the cache)
      const int page = kPaged ? p.tables[bi * p.max_blocks + tile] : 0;
      for (int idx = tid; idx < kb * vec; idx += kThreads) {
        const int j = idx / vec, c = idx - j * vec;
        uint4 kw = make_uint4(0, 0, 0, 0), vw = kw;
        size_t off;
        bool valid = true;
        if (kPaged) {
          off = ((size_t)(page * kb + j) * p.kv + kh) * dh;
        } else {
          const int pos = tile * kb + j;
          valid = pos < p.s_max;
          off = ((size_t)(bi * p.s_max + pos) * p.kv + kh) * dh;
        }
        if (valid) {
          kw = reinterpret_cast<const uint4*>(p.k + off)[c];
          vw = reinterpret_cast<const uint4*>(p.v + off)[c];
        }
        uint32_t* kd = k_s + j * L.wpr + 4 * c;
        uint32_t* vd = v_s + j * L.wpr + 4 * c;
        kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
        vd[0] = vw.x; vd[1] = vw.y; vd[2] = vw.z; vd[3] = vw.w;
      }
      __syncthreads();

      // ---- scores, masked in logical positions
      for (int idx = tid; idx < R * kb; idx += kThreads) {
        const int r = idx / kb, j = idx - r * kb;
        const uint32_t* qr = q_s + r * L.wpr;
        const uint32_t* kr = k_s + j * L.wpr;
        float dot = 0.f;
        for (int w = 0; w < hw; ++w) {
          const float2 a = bf2_to_f2(qr[w]), b = bf2_to_f2(kr[w]);
          dot = fmaf(a.x, b.x, dot);
          dot = fmaf(a.y, b.y, dot);
        }
        const int row = c0 + r, qi = row % nq;
        const int q_pos = len + q0 + qi, kv_pos = tile * kb + j;
        bool keep = kv_pos <= q_pos;
        if (p.window >= 0) keep = keep && kv_pos > q_pos - p.window;
        s_s[r * kb + j] = keep ? dot * p.scale : kNegInf;
      }
      __syncthreads();

      // ---- online softmax, one warp per row
      for (int r = warp; r < R; r += kWarps) {
        float* sr = s_s + r * kb;
        float mx = kNegInf;
        for (int j = lane; j < kb; j += 32) mx = fmaxf(mx, sr[j]);
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = lane; j < kb; j += 32) {
          const float e = expf(sr[j] - m_new);
          sr[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[r] = alpha * l_s[r] + sum;
          m_s[r] = m_new;
          a_s[r] = alpha;
        }
      }
      __syncthreads();

      // ---- acc = alpha * acc + P @ V
      for (int idx = tid; idx < R * hw; idx += kThreads) {
        const int r = idx / hw, w = idx - r * hw;
        const float* pr = s_s + r * kb;
        float2* a2 = reinterpret_cast<float2*>(acc + r * dh) + w;
        const float alpha = a_s[r];
        float ax = alpha * a2->x, ay = alpha * a2->y;
        for (int j = 0; j < kb; ++j) {
          const float pj = pr[j];
          const float2 vv = bf2_to_f2(v_s[j * L.wpr + w]);
          ax = fmaf(pj, vv.x, ax);
          ay = fmaf(pj, vv.y, ay);
        }
        *a2 = make_float2(ax, ay);
      }
      __syncthreads();
    }

    // ---- epilogue: normalize (empty row -> 0) and store bf16
    for (int idx = tid; idx < R * hw; idx += kThreads) {
      const int r = idx / hw, w = idx - r * hw;
      const int row = c0 + r, gi = row / nq, qi = row - gi * nq;
      float l = l_s[r];
      l = (l == 0.f) ? 1.f : l;
      const float2 a = reinterpret_cast<const float2*>(acc + r * dh)[w];
      const size_t off = ((size_t)(bi * p.n + q0 + qi) * p.h + kh * p.g + gi) * dh;
      reinterpret_cast<uint32_t*>(p.o + off)[w] = f2_to_bf2(a.x / l, a.y / l);
    }
    __syncthreads();
  }
}

template <bool kPaged>
int launch(Params p, cudaStream_t stream) {
  if (p.dh % 16 != 0 || p.dh > kMaxDh || p.k_block < 1 || p.k_block > kMaxKBlock ||
      p.q_block < 1 || p.n < 1 || p.kv < 1 || p.h % p.kv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  p.g = p.h / p.kv;
  p.row_chunk = std::min(kRowChunk, p.g * std::min(p.q_block, p.n));
  const size_t smem = sizeof(uint32_t) * (size_t)Layout(p.row_chunk, p.k_block, p.dh).total;
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const dim3 grid((p.n + p.q_block - 1) / p.q_block, p.kv, p.b);
  attn_kernel<kPaged><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_dense(const void* q, const void* k, const void* v, void* o,
                                      const void* lens, int b, int n, int h, int kv, int dh,
                                      int s_max, int q_block, int k_block, int window,
                                      float scale, void* tiles, void* stream) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lens = static_cast<const int*>(lens);
  p.tables = nullptr;
  p.tiles = static_cast<int*>(tiles);
  p.b = b; p.n = n; p.h = h; p.kv = kv; p.dh = dh;
  p.q_block = q_block; p.k_block = k_block;
  p.n_kv_tiles = (s_max + k_block - 1) / k_block;
  p.s_max = s_max; p.max_blocks = 0; p.window = window; p.scale = scale;
  return launch<false>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int decode_attention_paged(const void* q, const void* k_pool, const void* v_pool,
                                      void* o, const void* lens, const void* tables, int b,
                                      int n, int h, int kv, int dh, int block_size,
                                      int max_blocks, int q_block, int window, float scale,
                                      void* tiles, void* stream) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pool);
  p.v = static_cast<const __nv_bfloat16*>(v_pool);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lens = static_cast<const int*>(lens);
  p.tables = static_cast<const int*>(tables);
  p.tiles = static_cast<int*>(tiles);
  p.b = b; p.n = n; p.h = h; p.kv = kv; p.dh = dh;
  p.q_block = q_block; p.k_block = block_size;
  p.n_kv_tiles = max_blocks;
  p.s_max = 0; p.max_blocks = max_blocks; p.window = window; p.scale = scale;
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}

// Multi-position decode attention for Hopper (sm_90a), two addressing modes.
//
// Replaces the Pallas TPU kernels of the reference package,
// src/repro/kernels/decode_attention/kernel.py: decode_attention_pallas
// (dense per-slot cache) and decode_attention_paged_pallas (global paged
// pool + block tables).  Both Pallas entries share the body _attn_kernel;
// here both share attn_kernel, templated on how a kv position is addressed.
//
// What it computes.  For batch row b, the n new query positions sit at
// logical positions len_b .. len_b+n-1 (their K/V already written to the
// cache).  Each query row attends causally (optionally within a sliding
// window) over its row's cache: f32 scores, f32 online softmax, f32
// accumulation, bf16 output.  GQA: the g query heads of one kv head are
// folded into the rows of one block, as the Pallas kernel folds them
// into M = g*q_block.
//
// The kv range.  Its bounds are the Pallas skip rule (kernel.py:70-77)
// over kv tiles of k_block positions (128 for the dense cache, one page
// for the pool), for q tile iq of row b:
//   hi_tile = min(n_kv_tiles, cdiv(len_b + min(n, (iq+1)*q_block), k_block))
//   lo_tile = window ? max(0, floor((len_b + iq*q_block - window + 1) / k_block)) : 0
// so the launch executes exactly the tiles ops.slack_report counts as
// kv_tiles_executed (an optional device counter adds them up, and the
// spans beside them).  Scores are masked in logical positions
// (kernel.py:93-113) to the Pallas NEG_INF, so a position a row cannot see
// adds nothing once a visible one arrives; an empty row (l == 0) outputs 0.
//
// Grid.  One block per (kv head, batch row, q tile, span).  The q tile is
// select_q_block(n, dh) of the port's core/granularity.py, so the NFP
// predictor and this launch read the same M_attn; padded rows of the last
// q tile (query index >= n) are neither loaded nor stored.  A span is
// `span` consecutive kv tiles of the table (span j holds tiles j*span ..
// (j+1)*span - 1); the host picks span from the launch's shapes and the
// SM count (ops.kv_span), never from the lengths, which live on the
// device.  A block whose span holds none of its range's executed tiles
// exits at once; the others walk their part of the range.  So the
// longest row no longer sets the kernel's time: its work is spread over
// as many blocks as it has spans.
//
// Merge.  Where one span covers a range (the span covers the table, or the
// row is short), its block normalizes and stores bf16 as a whole-range
// kernel would.  Otherwise each span's block writes its unnormalized
// partial (running max, sum, f32 accumulator per query row) to f32
// scratch, fences, and takes a ticket on the range's arrival counter; the
// last block to arrive merges the range's spans in span order (so the
// result does not depend on which block came last), stores bf16 and sets
// the counter back to 0, so the next launch (or graph replay) finds it 0.
// The merge runs inside attn_kernel: one launch per call.
//
// Addressing.  Dense: position pos of row b is at ((b*s_max + pos)*kv +
// kh)*dh; positions >= s_max (an s_max that is no multiple of 128) are
// zero-filled, as the reference pads the cache with zeros to whole tiles,
// and fall to the causal mask.  Paged: page = table[b][pos / bs], and the
// position is at ((page*bs + pos % bs)*kv + kh)*dh; a block reads its
// span's table entries into shared memory beside the row length, before
// its first copy, so no copy waits on a dependent table load.  The
// executed tiles are walked whole, as the Pallas kernel computes whole
// tiles, and masked.
//
// What bounds it on this card.  Decode attention is memory-bound: the
// least time is the K/V bytes of the executed tiles (plus q and o) over
// 3.35 TB/s.  A block alone is latency-bound (the row length and the
// table, then its K/V, each a round trip to device memory, two pipeline
// steps in flight), so the kernel nears the bytes' bound only with many
// blocks streaming at once: hence the spans.  What then holds a streaming
// block back is its own instruction stream as much as the memory: with the
// head dim and the kv tile known at compile time (attn_kernel's instances)
// the copies' index arithmetic shrinks and the kernel ran 14-22 % faster
// at the serving cells' lengths on an H100 SXM, where deeper rings of
// smaller steps, bulk copies on mbarriers and persistent blocks over a
// list of the live spans were no faster (PERF.md, PR 32).  An SM holds
// three blocks at dh 80 (shared memory), four at dh 64, two at dh 128.
//
// A block's pipeline.  It walks its tiles in 16-position chunks, four
// chunks to a pipeline step, in a ring of three steps in shared memory:
// the 16-byte cp.async.cg copies of the next two steps (eight chunks of K
// and V, each copy asking L2 for its whole 128-byte line) are in flight
// while one step is computed, with one barrier per step.  The span is
// split again inside the block: with one 16-row m-tile of query rows (n =
// 1 up to 16 rows of g·n) each of the four warps takes every fourth chunk,
// with two m-tiles two warps share a tile and take every second chunk,
// with three or four each warp takes one m-tile and every chunk.  Each
// warp keeps its own running max, sum and f32 accumulator in registers; at
// the end the partials of one m-tile are merged in split order 0, 1, 2, 3,
// so the result is deterministic.  More than 64 rows (n = 65, or a GQA
// fold) loop over 64-row chunks.  A chunk's query rows pass through the
// ring's last stage on their way to registers.
// The math runs on tensor cores (mma.sync.m16n8k16, f32 accumulation;
// query rows past the block's rows are zero): Q·Kᵀ from bf16 q and K,
// exact products; P·V with the f32 probabilities split into bf16 hi + lo,
// two products per step, so P keeps about 16 bits, as the Pallas kernel's
// f32 p.  Rows of shared memory carry a 16-byte pad, so ldmatrix reads
// them without bank conflicts.
//
// Accepted inputs: bf16 q/k/v, dh % 16 == 0 and dh <= 128, k_block <= 128,
// 1 <= span <= kMaxSpan, contiguous tensors, 16-byte-aligned bases; with
// more than one span, f32 scratch and zeroed int32 counters (ops.py sizes
// both).  Launches that share counters must not run at once.  The C entry
// points return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kThreads = 128;
constexpr int kMaxDh = 128;
constexpr int kMaxKBlock = 128;
constexpr int kMaxSpan = 1024;  // kv tiles of one span (its table entries sit in shared memory)
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kChunk = 16;     // kv positions of one chunk: the depth of one m16n8k16
constexpr int kSlots = 4;      // chunks of one pipeline step
constexpr int kSteps = 3;      // steps in the ring: two in flight while one is computed
constexpr int kTileRows = 64;  // query rows of one row chunk: four 16-row m-tiles

struct Params {
  const __nv_bfloat16* q;  // (b, n, h, dh)
  const __nv_bfloat16* k;  // dense (b, s_max, kv, dh) | paged (n_phys, k_block, kv, dh)
  const __nv_bfloat16* v;
  __nv_bfloat16* o;        // (b, n, h, dh)
  const int* lens;         // (b,) committed positions per row
  const int* tables;       // paged: (b, max_blocks) logical tile -> physical page
  float* part;             // more than one span: (range, span, g*min(q_block, n), dh + 2) partials
  int* count;              // more than one span: (range,) arrivals, 0 between launches
  int* tiles;              // optional: [0] += kv tiles executed, [1] += spans executed
  int b, n, h, kv, g, dh;
  int q_block, k_block, n_kv_tiles;
  int span, n_spans, n_q_tiles;
  int s_max;               // dense: positions per cache row
  int window;              // < 0: no window
  float scale;
};

// Shared memory in bf16 elements: the ring of kSteps steps, each kSlots
// (K chunk, V chunk) pairs; then (paged) the span's int table entries.
// The query rows sit in the last stage (from offset `rows`) until the
// pipeline first fills it, after they went to registers.  Rows hold
// dh + 8 elements (`ld`): the 16-byte pad staggers the banks for ldmatrix.
struct Layout {
  int ld, chunk, step, rows, total;
  __host__ __device__ explicit Layout(int dh) {
    ld = dh + 8;
    chunk = kChunk * ld;
    step = kSlots * 2 * chunk;
    rows = (kSteps - 1) * step;
    total = kSteps * step;
  }
  __host__ __device__ size_t bytes(int table) const {
    return sizeof(__nv_bfloat16) * (size_t)total + sizeof(int) * (size_t)table;
  }
};

// cp_async16 with an L2 prefetch of the whole 128-byte line: a row of
// one kv head (dh * 2 bytes) spans two lines, which the kv heads' blocks
// beside it read at about the same time
__device__ inline void cp_async16_l2(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ inline uint32_t f2_to_bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x, y -> bf16x2 hi and the bf16x2 of what hi leaves over
__device__ inline void split_bf2(float x, float y, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = f2_to_bf2(x - back.x, y - back.y);
}

// kDh, kKb: the head dim and the kv tile at compile time (the served
// models' dh 64, 80, 96 and 128; a 16-position page, the dense
// 128-position tile), which turns the copies' index arithmetic into shifts and
// multiplies, and at dh 64 leaves registers and ring room for four blocks
// an SM; or 0, 0: any dh up to kMaxDh, any kv tile up to kMaxKBlock
template <bool kPaged, int kDh, int kKb>
__global__ void __launch_bounds__(kThreads, kDh == 64 ? 4 : 1) attn_kernel(Params p) {
  constexpr int kD = kDh > 0 ? kDh : kMaxDh;  // the widest dh the registers hold
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_arrival;
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int sp = blockIdx.z / p.n_q_tiles, iq = blockIdx.z - sp * p.n_q_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = kKb > 0 ? kKb : p.k_block, dh = kDh > 0 ? kDh : p.dh;
  const int vec = dh / 8, nk16 = dh / 16;
  const Layout L(dh);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* q_s = ring + L.rows;
  int* table_s = reinterpret_cast<int*>(ring + L.total);
  const uint32_t q_base = smem_addr(q_s), ring_base = smem_addr(ring);

  // the row length, and beside it the span's table entries
  const int len = p.lens[bi];
  const int t_first = sp * p.span;
  if (kPaged) {
    const int* table = p.tables + (size_t)bi * p.n_kv_tiles + t_first;
    const int m = min(p.span, p.n_kv_tiles - t_first);
    for (int j = tid; j < m; j += kThreads) table_s[j] = __ldg(table + j);
  }
  const int q0 = iq * p.q_block;             // first query index of this q tile
  const int nq = min(p.q_block, p.n - q0);   // valid query rows per head
  const int rows = p.g * nq;                 // valid rows of the block

  // the Pallas skip rule, then the spans holding executed tiles
  const int hi = len + min(p.n, q0 + p.q_block);
  const int hi_tile = min(p.n_kv_tiles, (hi + kb - 1) / kb);
  int lo_tile = 0;
  if (p.window >= 0) {
    const int lo_visible = len + q0 - p.window + 1;
    lo_tile = lo_visible > 0 ? lo_visible / kb : 0;
  }
  const bool empty = hi_tile <= lo_tile;     // span 0 alone stores the zeros
  const int sp_lo = empty ? 0 : lo_tile / p.span, sp_hi = empty ? 0 : (hi_tile - 1) / p.span;
  if (sp < sp_lo || sp > sp_hi) return;
  const bool split = sp_hi > sp_lo;
  const int t0 = empty ? 0 : max(lo_tile, t_first);
  const int t1 = empty ? 0 : min(hi_tile, t_first + p.span);
  if (p.tiles != nullptr && tid == 0) {
    atomicAdd(p.tiles, t1 - t0);
    atomicAdd(p.tiles + 1, 1);
  }
  const int pos0 = t0 * kb, pos1 = t1 * kb;
  const int chunks = (pos1 - pos0 + kChunk - 1) / kChunk;
  const int steps = (chunks + kSlots - 1) / kSlots;
  const int range = (bi * p.kv + kh) * p.n_q_tiles + iq;
  const int rows_pad = p.g * min(p.q_block, p.n), pld = dh + 2;
  __syncthreads();  // the table entries have landed

  // K and V of step s's chunks into ring stage s % kSteps; positions past
  // the span's tiles (and, dense, past the cache) are zero
  auto load_step = [&](int s) {
    const uint32_t st = ring_base + 2u * (uint32_t)((s % kSteps) * L.step);
    const int first = s * kSlots;
    for (int idx = tid; idx < kSlots * kChunk * vec; idx += kThreads) {
      const int r = idx / vec, c = idx - r * vec, slot = r / kChunk;
      if (first + slot >= chunks) break;
      const int pos = pos0 + first * kChunk + r;
      bool ok = pos < pos1;
      size_t row = 0;
      if (kPaged) {
        if (ok) row = (size_t)table_s[pos / kb - t_first] * kb + pos % kb;
      } else {
        ok = ok && pos < p.s_max;
        row = (size_t)bi * p.s_max + pos;
      }
      const size_t off = ok ? (row * p.kv + kh) * dh + c * 8 : 0;
      const uint32_t kd = st + 2u * (uint32_t)(2 * slot * L.chunk + (r % kChunk) * L.ld + c * 8);
      cp_async16_l2(kd, p.k + off, ok);
      cp_async16_l2(kd + 2u * L.chunk, p.v + off, ok);
    }
  };

  for (int c0 = 0; c0 < rows; c0 += kTileRows) {
    const int R = min(kTileRows, rows - c0);
    const int mt = (R + 15) / 16;
    // warp -> (m-tile, kv split): 1 m-tile: 4 splits; 2: 2; 3 or 4: 1
    const int splits = mt == 1 ? 4 : (mt == 2 ? 2 : 1);
    const int mi = warp / splits, si = warp - mi * splits;
    const bool active = mi < mt;

    for (int s = 0; s < kSteps - 1; ++s) {
      if (s < steps) load_step(s);
      cp_async_commit();
    }
    // ---- resident query rows (row = gi*nq + qi, the Pallas g*q_block fold),
    // zero past R up to the m-tile
    for (int idx = tid; idx < mt * 16 * vec; idx += kThreads) {
      const int r = idx / vec, c = idx - r * vec;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (r < R) {
        const int row = c0 + r, gi = row / nq, qi = row - gi * nq;
        const size_t off = ((size_t)(bi * p.n + q0 + qi) * p.h + kh * p.g + gi) * dh;
        w = reinterpret_cast<const uint4*>(p.q + off)[c];
      }
      *reinterpret_cast<uint4*>(q_s + r * L.ld + c * 8) = w;
    }
    __syncthreads();

    uint32_t qf[kD / 16][4];
    float acc[kD / 8][4];
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    int q_pos[2];
#pragma unroll
    for (int t = 0; t < kD / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = c0 + mi * 16 + (lane >> 2) + hf * 8;
      q_pos[hf] = len + q0 + row % nq;
    }
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        if (kk < nk16)
          ldsm_x4(qf[kk], q_base + 2u * (uint32_t)((mi * 16 + (lane & 15)) * L.ld + kk * 16 +
                                                   (lane >> 4) * 8));
      }
    }

    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kSteps - 2>();
      __syncthreads();  // step s has landed; the stage refilled next is consumed
      if (s + kSteps - 1 < steps) load_step(s + kSteps - 1);
      cp_async_commit();
      if (!active) continue;
      const uint32_t st = ring_base + 2u * (uint32_t)((s % kSteps) * L.step);
      for (int slot = 0; slot < kSlots; ++slot) {
        const int ci = s * kSlots + slot;
        if (ci >= chunks) break;
        if (ci % splits != si) continue;
        const uint32_t kt = st + 2u * (uint32_t)(2 * slot * L.chunk), vt = kt + 2u * L.chunk;
        const int cpos = pos0 + ci * kChunk;

        // ---- scores of 16 rows x 16 positions: Q·Kᵀ
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          if (kk >= nk16) break;
          uint32_t kf[4];
          ldsm_x4(kf, kt + 2u * (uint32_t)(((lane & 7) + (lane >> 4) * 8) * L.ld + kk * 16 +
                                           ((lane >> 3) & 1) * 8));
          mma16816(sc[0], qf[kk], kf[0], kf[1]);
          mma16816(sc[1], qf[kk], kf[2], kf[3]);
        }
        // ---- masked in logical positions, online softmax per row
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = kNegInf;
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kv_pos = cpos + t * 8 + (lane & 3) * 2 + e;
              bool keep = kv_pos < pos1 && kv_pos <= q_pos[hf];
              if (p.window >= 0) keep = keep && kv_pos > q_pos[hf] - p.window;
              float& x = sc[t][hf * 2 + e];
              x = keep ? x * p.scale : kNegInf;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[hf], mx);
          const float alpha = expf(m_run[hf] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[t][hf * 2 + e];
              x = expf(x - m_new);
              sum += x;
            }
          m_run[hf] = m_new;
          l_run[hf] = alpha * l_run[hf] + sum;  // this thread's columns; quad-summed at the end
#pragma unroll
          for (int t = 0; t < kD / 8; ++t) {
            acc[t][hf * 2] *= alpha;
            acc[t][hf * 2 + 1] *= alpha;
          }
        }
        // ---- acc += P·V, P as bf16 hi + lo A fragments
        uint32_t ph[4], pl[4];
        split_bf2(sc[0][0], sc[0][1], &ph[0], &pl[0]);
        split_bf2(sc[0][2], sc[0][3], &ph[1], &pl[1]);
        split_bf2(sc[1][0], sc[1][1], &ph[2], &pl[2]);
        split_bf2(sc[1][2], sc[1][3], &ph[3], &pl[3]);
#pragma unroll
        for (int j = 0; j < kD / 16; ++j) {
          if (j >= nk16) break;
          uint32_t vf[4];
          ldsm_x4_trans(vf, vt + 2u * (uint32_t)(((lane & 7) + ((lane >> 3) & 1) * 8) * L.ld +
                                                 j * 16 + (lane >> 4) * 8));
          mma16816(acc[2 * j], ph, vf[0], vf[1]);
          mma16816(acc[2 * j], pl, vf[0], vf[1]);
          mma16816(acc[2 * j + 1], ph, vf[2], vf[3]);
          mma16816(acc[2 * j + 1], pl, vf[2], vf[3]);
        }
      }
    }

    // ---- merge the splits of each m-tile in split order; one span: normalize
    // (empty row -> 0) and store bf16, else store the span's partial.  The
    // ring becomes the merge scratch
    cp_async_wait<0>();
    __syncthreads();
    float* scr = reinterpret_cast<float*>(ring);
    const int sld = dh + 4, wsz = 16 * sld + 32;  // per warp: acc rows, m, l
    if (active) {
      float* ws = scr + warp * wsz;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float l = l_run[hf];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int r = (lane >> 2) + hf * 8;
        if ((lane & 3) == 0) {
          ws[16 * sld + r] = m_run[hf];
          ws[16 * sld + 16 + r] = l;
        }
#pragma unroll
        for (int t = 0; t < kD / 8; ++t) {
          if (t >= 2 * nk16) break;
          const int col = t * 8 + (lane & 3) * 2;
          ws[r * sld + col] = acc[t][hf * 2];
          ws[r * sld + col + 1] = acc[t][hf * 2 + 1];
        }
      }
    }
    __syncthreads();
    const int hw = dh / 2;
    float* span_part = split ? p.part + ((size_t)range * p.n_spans + sp) * rows_pad * pld : nullptr;
    for (int idx = tid; idx < R * hw; idx += kThreads) {
      const int r = idx / hw, w = idx - r * hw, rr = r & 15;
      const float* first = scr + (r >> 4) * splits * wsz;
      float m_all = kNegInf;
      for (int k = 0; k < splits; ++k) m_all = fmaxf(m_all, first[k * wsz + 16 * sld + rr]);
      float l = 0.f, ax = 0.f, ay = 0.f;
      for (int k = 0; k < splits; ++k) {
        const float* ws = first + k * wsz;
        const float f = expf(ws[16 * sld + rr] - m_all);
        l += f * ws[16 * sld + 16 + rr];
        ax += f * ws[rr * sld + 2 * w];
        ay += f * ws[rr * sld + 2 * w + 1];
      }
      const int row = c0 + r;
      if (split) {
        float* pr = span_part + (size_t)row * pld;
        pr[2 * w] = ax;
        pr[2 * w + 1] = ay;
        if (w == 0) {
          pr[dh] = m_all;
          pr[dh + 1] = l;
        }
        continue;
      }
      l = (l == 0.f) ? 1.f : l;
      const int gi = row / nq, qi = row - gi * nq;
      const size_t off = ((size_t)(bi * p.n + q0 + qi) * p.h + kh * p.g + gi) * dh;
      reinterpret_cast<uint32_t*>(p.o + off)[w] = f2_to_bf2(ax / l, ay / l);
    }
    __syncthreads();  // the scratch is the next row chunk's ring
  }
  if (!split) return;

  // ---- the last span of the range to arrive merges the partials in span
  // order, stores bf16 and resets the range's counter
  __threadfence();
  __syncthreads();
  if (tid == 0) last_arrival = atomicAdd(p.count + range, 1) == sp_hi - sp_lo;
  __syncthreads();
  if (!last_arrival) return;
  __threadfence();
  const int hw = dh / 2;
  const float* parts = p.part + (size_t)range * p.n_spans * rows_pad * pld;
  const size_t span_stride = (size_t)rows_pad * pld;
  for (int idx = tid; idx < rows * hw; idx += kThreads) {
    const int row = idx / hw, w = idx - row * hw;
    float m_all = kNegInf;
    for (int j = sp_lo; j <= sp_hi; ++j)
      m_all = fmaxf(m_all, __ldcg(parts + j * span_stride + (size_t)row * pld + dh));
    float l = 0.f, ax = 0.f, ay = 0.f;
    for (int j = sp_lo; j <= sp_hi; ++j) {
      const float* pr = parts + j * span_stride + (size_t)row * pld;
      const float f = expf(__ldcg(pr + dh) - m_all);
      l += f * __ldcg(pr + dh + 1);
      ax += f * __ldcg(pr + 2 * w);
      ay += f * __ldcg(pr + 2 * w + 1);
    }
    l = (l == 0.f) ? 1.f : l;
    const int gi = row / nq, qi = row - gi * nq;
    const size_t off = ((size_t)(bi * p.n + q0 + qi) * p.h + kh * p.g + gi) * dh;
    reinterpret_cast<uint32_t*>(p.o + off)[w] = f2_to_bf2(ax / l, ay / l);
  }
  if (tid == 0) p.count[range] = 0;
}

// raise an instance's dynamic shared-memory limit once, to the most any
// launch of it takes, and launch it
template <bool kPaged, int kDh, int kKb>
int launch_instance(const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const size_t most = Layout(kDh > 0 ? kDh : kMaxDh).bytes(kPaged ? kMaxSpan : 0);
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<kPaged, kDh, kKb>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(p.kv, p.b, p.n_q_tiles * p.n_spans);
  const size_t smem = Layout(p.dh).bytes(kPaged ? p.span : 0);
  attn_kernel<kPaged, kDh, kKb><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// check, then launch the instance for this head dim
template <bool kPaged>
int launch(Params p, cudaStream_t stream) {
  if (p.dh % 16 != 0 || p.dh > kMaxDh || p.k_block < 1 || p.k_block > kMaxKBlock ||
      p.q_block < 1 || p.n < 1 || p.kv < 1 || p.h % p.kv != 0 || p.span < 1 ||
      p.span > kMaxSpan || p.n_kv_tiles < 1)
    return (int)cudaErrorInvalidValue;
  p.g = p.h / p.kv;
  p.n_q_tiles = (p.n + p.q_block - 1) / p.q_block;
  p.n_spans = (p.n_kv_tiles + p.span - 1) / p.span;
  if (p.n_spans > 1 && (p.part == nullptr || p.count == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int kb = kPaged ? 16 : 128;  // the engine's page, the dense tile
  if (p.k_block == kb) {
    switch (p.dh) {
      case 64: return launch_instance<kPaged, 64, kb>(p, stream);
      case 80: return launch_instance<kPaged, 80, kb>(p, stream);
      case 96: return launch_instance<kPaged, 96, kb>(p, stream);
      case 128: return launch_instance<kPaged, 128, kb>(p, stream);
      default: break;
    }
  }
  return launch_instance<kPaged, 0, 0>(p, stream);
}

}  // namespace

extern "C" int decode_attention_dense(const void* q, const void* k, const void* v, void* o,
                                      const void* lens, int b, int n, int h, int kv, int dh,
                                      int s_max, int q_block, int k_block, int span, int window,
                                      float scale, void* part, void* count, void* tiles,
                                      void* stream) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lens = static_cast<const int*>(lens);
  p.tables = nullptr;
  p.part = static_cast<float*>(part);
  p.count = static_cast<int*>(count);
  p.tiles = static_cast<int*>(tiles);
  p.b = b; p.n = n; p.h = h; p.kv = kv; p.dh = dh;
  p.q_block = q_block; p.k_block = k_block;
  p.n_kv_tiles = (s_max + k_block - 1) / k_block;
  p.span = span;
  p.s_max = s_max; p.window = window; p.scale = scale;
  return launch<false>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int decode_attention_paged(const void* q, const void* k_pool, const void* v_pool,
                                      void* o, const void* lens, const void* tables, int b,
                                      int n, int h, int kv, int dh, int block_size,
                                      int max_blocks, int q_block, int span, int window,
                                      float scale, void* part, void* count, void* tiles,
                                      void* stream) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pool);
  p.v = static_cast<const __nv_bfloat16*>(v_pool);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lens = static_cast<const int*>(lens);
  p.tables = static_cast<const int*>(tables);
  p.part = static_cast<float*>(part);
  p.count = static_cast<int*>(count);
  p.tiles = static_cast<int*>(tiles);
  p.b = b; p.n = n; p.h = h; p.kv = kv; p.dh = dh;
  p.q_block = q_block; p.k_block = block_size;
  p.n_kv_tiles = max_blocks;
  p.span = span;
  p.s_max = 0; p.window = window; p.scale = scale;
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}

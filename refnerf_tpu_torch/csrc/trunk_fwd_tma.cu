// The bf16 trunk forward for Hopper (sm_90a) at widths 256 and 128: wgmma
// products fed by a TMA weight ring.
//
// Replaces, for the compute dtype bfloat16 at width 256, the forward Pallas
// kernel `_fwd_kernel` (:612-666) of refnerf_tpu/ops/pallas/fused_mlp.py in
// the modes of trunk_fwd.cu: K1 (the spatial trunk and its heads), K2 (the
// directional trunk), K3 (K1 with the density gradient, `_inner_chain`
// :589-609 and the fold :651-662), K6 and K7 on K1/K3 (the compositing
// weights `_epilogue_fwd` :498, the IPE `_segments` :550-563), K8-K10 on K2
// (the IDE `_ide_fwd` :402, the direction geometry `_dir_geometry` :355,
// the colour epilogue `_rgb_epilogue` :283), K11 on K1 (y out, :617,
// :629-630); and at width 128 in the plain K2 (mip-NeRF's directional
// trunk, `fwd_two_tiles`). It computes what trunk_fwd.cu computes, with the
// same arithmetic and bf16 roundings (trunk_fwd.cu:35-47: each f32 sum
// rounded to bf16 before the bf16 bias add, then ReLU; sigma and the f32
// heads on f32(y); the bottleneck cdt(y wc^T) + cdt(bc); K3's chain q =
// cdt(s_l Wa_l) with u_x summed in f32 over the skip layer and layer 0; y
// the last activation in bf16), from the same C arguments; and K1 and K3 on
// more than kW and at most kWideKin input columns with sigma, the f32 heads
// and a 128- or 256-wide bottleneck (`fwd_wide`: mip-NeRF 360's proposal
// MLP and the JAX package's default MLP, 504 IPE columns; trunk_fwd.cu's
// mma.sync design ran the former before). The float32 instances, and trunks past
// kMaxDepth layers or those input columns, stay in trunk_fwd_f32.cu and
// trunk_fwd.cu.
//
// Bound on the H100: the products, ~1.09 MFLOP a sample for K1 and ~2.10
// for K3 (0.57 / 1.10 TFLOP at N = 524,288; 0.58 / 1.12 ms at 989 TFLOP/s),
// ~0.31 for K2 at width 128 (0.16 TFLOP, 0.17 ms); device memory carries
// only the inputs and outputs (~0.1-0.3 GB, under 0.1 ms; K11's y 268 MB,
// 0.08 ms). A 64-row tile reads each layer's weights (128 KB) from L2 for
// 8.4 MFLOP, 64 FLOP a byte. The proposal trunk (4 x 256 on 504 columns)
// needs ~0.65 MFLOP a sample (0.342 TFLOP, 0.35 ms at N = 524,288) and
// reads ~1 KB of input a sample (0.53 GB, 0.16 ms).
//
// Design (trunk_bwd_tma.cu's, whose building blocks are in hopper_tma.cuh).
//  - Two consumer warpgroups and a producer warpgroup, one warp of which
//    issues the TMA loads; setmaxnreg gives the producer 40 registers a
//    thread and the consumers' code 232 (ptxas reports the launch's 168). The CTAs are persistent, one an SM, each
//    walking units of 64-row tiles, so the producer loads a unit's first
//    weights during the last epilogues of the one before. Each product runs
//    as wgmma m64n128k16, warpgroup g owning output columns [128 g, 128 g +
//    128): 64 f32 accumulators a thread and tile, acc[t][4 j + 2 h + e] at
//    row 16 w + lane / 4 + 8 h, column 128 g + 8 j + 2 (lane % 4) + e.
//  - Two tiles at a time (NT = 2) but with K3: each weight slice serves the
//    products of both, so a sample reads half the weights from L2, which
//    bounds the one-tile design; units of two tiles, or with K6 of whole
//    rays in an even number of tiles. K3 runs one tile at a time (NT = 1):
//    its relu' bits and its chain's state do not fit twice.
//  - The activation and input tiles stay in shared memory in wgmma's
//    128-byte-swizzled K-major layout; the weights come by TMA from the
//    forward pack `w`, `wc` and, for K3's chain, the transposed pack `wt`,
//    in [256][64] slices through a ring of 2-4 stages (the most that fits
//    beside NT tiles). The producer walks the consumers' `schedule`, so the
//    next layer's weights arrive during an epilogue.
//  - The raw inputs of a tile are staged in shared memory first, every
//    load in flight at once (16-byte loads of the segments, which a tile
//    holds as one contiguous block; K7's lm, lv; K8's directions), and the
//    input tile is made from there: with one CTA an SM nothing else hides a
//    load's latency.
//  - The epilogues work in registers: bias, ReLU and rounding on bf16 pairs
//    (one rounding of the exact sum of two bf16 values is the rounding of
//    their f32 sum), K3's relu' bits in the accumulator's own order; sigma
//    and the f32 heads as dot products of the thread's 32 columns of y with
//    the heads' weights (in shared memory where they fit), summed over a
//    quad's 4 lanes by shuffles and over the two warpgroups through shared
//    memory; the bottleneck head straight from its accumulators; K3's u_x
//    summed in an f32 tile as each of its two products comes out, then
//    folded as trunk_fwd.cu folds it. No wgmma sits on a branch.
//  - K11: y leaves from the registers where the last epilogue left it,
//    after the layers (a quad's 4 lanes write 16 contiguous bytes of a row
//    a store): no pass over the tile, and nothing more live across the
//    products, where NT = 2's 128 accumulators fill the registers (a TMA
//    store of the tiles, or stores in the epilogue, made ptxas spill
//    them). Its input tiles are made by `fill_chunks`, 16 bytes a copy.
// What bounds it on the card (PERF.md): the weights stream from L2 at 64
// FLOP a byte for a 64-row tile (~1.1 MB a tile for K1, ~2.2 MB for K3),
// and the epilogues leave the tensor cores idle.

#include <string.h>

#define PHASE_SYNC() cons_sync()  // closes a stamped segment
#include "hopper_tma.cuh"
#include "trunk_fwd_args.cuh"

namespace {

constexpr int kStages = 4;
constexpr int kMaxHeads = 16;  // f32 heads: their partial sums fit in `red`
constexpr int kXst = 8 * kRows;  // floats of staged raw inputs: K7's lm, lv; K8's g, v, k
// Two consumer warpgroups and a producer warpgroup (one warp of it issues
// the TMA loads): whole warpgroups, so that setmaxnreg can move registers
// from the producer (kProdRegs) to the consumers (kConsRegs).
constexpr int kFwdThreads = kCons + 128;
constexpr int kProdRegs = 40, kConsRegs = 232;

struct FwdMaps {
  CUtensorMap w[kMaxDepth];   // layer l of `w`: [W][K_l], box 64 x 256
  CUtensorMap wt[kMaxDepth];  // layer l of `wt`: [K_l][W] (K3's chain)
  CUtensorMap wc;             // [HC][W]
  int stages;                 // of the weight ring
  int tiles;                  // 64-row tiles of a unit, a multiple of NT
  int heads_in_smem;          // the f32 heads' weights fit in shared memory
  int small_in_act;           // xst and red live in the activation tiles
};

// acc[t] = A_t[64][K] B^T for the NT tiles t with B the next ceil(K / 64)
// slices of the ring: each slice serves all NT tiles. A_t's K-slices s < n0
// are the blocks of a0[t], the rest those of a1[t]. Otherwise as `product`
// (hopper_tma.cuh), `acc_in` too. No wgmma sits on a branch: a warpgroup
// whose output columns lie past a product's (the 128-wide bottleneck, u_x
// of kin <= 128) multiplies the zero rows that TMA fills past a tensor
// map's extent.
template <int NT>
__device__ __forceinline__ void product_n(float (&acc)[NT][64], const uint32_t (&a0)[NT], int n0,
                                          const uint32_t (&a1)[NT], int K, Ring& r,
                                          int acc_in = 0) {
  const int wg = threadIdx.x >> 7;
  const int ns = (K + kBK - 1) / kBK;
  int prev = 0;
  wg_fence();
  for (int s = 0; s < ns; ++s) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t b = r.base + r.stage * kSlice + wg * (kSlice / 2);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const uint32_t a = s < n0 ? a0[t] + s * kBlk : a1[t] + (s - n0) * kBlk;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma128<0, 0>(acc[t], sw128_desc(a + 32 * kk, 16, 1024),
                       sw128_desc(b + 32 * kk, 16, 1024), s | kk | acc_in);
    }
    wg_commit();
    if (s > 0) {
      wg_wait<1>();
      if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * prev);
    }
    prev = r.stage;
    r.advance();
  }
  wg_wait<0>();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * prev);
#pragma unroll
  for (int t = 0; t < NT; ++t) acc_fence(acc[t]);
}

template <int W = kW>
__device__ __forceinline__ int k_dim(const FwdParams& p, int l) {
  return l == 0 ? p.kin : (l == p.skip ? W + p.kin : W);
}

// The products of one tile in order, as (tensor map, first B row, K); the
// producer loads their slices, and the kernel below runs them in this order.
template <int HC, typename F>
__device__ void schedule(const FwdParams& p, const FwdMaps& m, F&& load) {
  for (int l = 0; l < p.depth; ++l) load(&m.w[l], 0, k_dim(p, l));  // the layers
  if (HC > 0) load(&m.wc, 0, kW);                                    // the bottleneck
  if (p.u != nullptr)                                                // K3's chain
    for (int l = p.depth - 1; l >= 0; --l) {
      if (l == p.skip) load(&m.wt[l], kW, kW);  // u_x: the skip layer's input columns
      load(&m.wt[l], 0, kW);                    // s_{l-1}; at l = 0, u_x of layer 0
    }
}

// The wide-input instance's schedule with K3 (`fwd_wide` at NT = 1): the
// layers and the bottleneck as `schedule`, then the chain, whose u_x
// products run over the kin input columns 256 at a time.
template <int HC, typename F>
__device__ void schedule_wide(const FwdParams& p, const FwdMaps& m, F&& load) {
  for (int l = 0; l < p.depth; ++l) load(&m.w[l], 0, k_dim(p, l));
  if (HC > 0) load(&m.wc, 0, kW);
  for (int l = p.depth - 1; l >= 0; --l) {
    if (l == p.skip)
      for (int c = 0; c < p.kin; c += kW) load(&m.wt[l], kW + c, kW);  // u_x: skip columns
    if (l > 0)
      load(&m.wt[l], 0, kW);  // s_{l-1}
    else
      for (int c = 0; c < p.kin; c += kW) load(&m.wt[0], c, kW);  // u_x: layer 0's
  }
}

// One f32 head on y (the thread's 32 columns of its two rows, in registers)
// with its weights wv (shared or device memory): the dot products summed
// over the quad's 4 lanes, to rw[row][slot].
__device__ __forceinline__ void head_part(const float (&y)[64], const float* wv, int fc, int fr,
                                          float* rw, int nred, int slot) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 w = *reinterpret_cast<const float2*>(wv + fc + 8 * j);
    s0 = fmaf(y[4 * j], w.x, s0);
    s0 = fmaf(y[4 * j + 1], w.y, s0);
    s1 = fmaf(y[4 * j + 2], w.x, s1);
    s1 = fmaf(y[4 * j + 3], w.y, s1);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if ((threadIdx.x & 3) == 0) {
    rw[fr * nred + slot] = s0;
    rw[(fr + 8) * nred + slot] = s1;
  }
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tile's rows [row0, row0 + rows) of a [n][d] segment, one contiguous
// block of rows * d values, to `st` in shared memory: 16-byte loads where
// the block is 16-byte aligned, kStage of them in flight a thread.
constexpr int kStage = 4;
__device__ void stage_block(bf16* st, const bf16* x, int d, int row0, int rows) {
  if (x == nullptr || d == 0) return;
  const bf16* src = x + static_cast<size_t>(row0) * d;
  const int count = rows * d;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int nv = count >> 3;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(st);
    for (int i0 = threadIdx.x; i0 < nv; i0 += kStage * kCons) {
      uint4 v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (i0 + u * kCons < nv) v[u] = __ldg(s4 + i0 + u * kCons);
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (i0 + u * kCons < nv) d4[i0 + u * kCons] = v[u];
    }
    done = nv << 3;
  }
  for (int i = done + threadIdx.x; i < count; i += kCons) st[i] = src[i];
}

// The input tile from the staged segments s0 [rows][d0], s1 [rows][d1]:
// columns [x0 | the IDE block (dide columns, left for ide_fill_staged) |
// x1], zeros past them and past `rows`, 16 bytes of a row a store.
__device__ void fill_input(unsigned char* tile, const bf16* s0, int d0, const bf16* s1, int d1,
                           int dide, int kp, int rows) {
  const int cpr = kp >> 3;
  const unsigned short* h0 = reinterpret_cast<const unsigned short*>(s0);
  const unsigned short* h1 = reinterpret_cast<const unsigned short*>(s1);
  for (int q = threadIdx.x; q < kRows * cpr; q += kCons) {
    const int r = q / cpr, c0 = (q - r * cpr) << 3;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (r < rows) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + e, c1 = c - d0 - dide;
        uint32_t v = 0u;
        if (c < d0)
          v = h0[r * d0 + c];
        else if (c1 >= 0 && c1 < d1)
          v = h1[r * d1 + c1];
        w[e >> 1] |= v << (16 * (e & 1));
      }
    }
    *reinterpret_cast<uint4*>(tile + sw_off(r, c0)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// fill_input without the IDE block and without its branch a value, which
// waits on each 2-byte load in turn: a chunk of 8 columns inside a segment
// whose width (and the one's before it) is a multiple of 8 is one 16-byte
// copy, any other chunk 8 loads from clamped indices and selects. NTH
// threads share the work (the consumers, or at width 128 one warpgroup).
template <int NTH>
__device__ void fill_chunks(unsigned char* tile, const bf16* s0, int d0, const bf16* s1, int d1,
                            int kp, int rows) {
  const int cpr = kp >> 3, tid = threadIdx.x & (NTH - 1);
  const unsigned short* h0 = reinterpret_cast<const unsigned short*>(s0);
  const unsigned short* h1 = reinterpret_cast<const unsigned short*>(s1);
  const bool vec0 = (d0 & 7) == 0, vec1 = vec0 && (d1 & 7) == 0;
  for (int q = tid; q < kRows * cpr; q += NTH) {
    const int r = q / cpr, c0 = (q - r * cpr) << 3, k0 = c0 - d0;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      if (vec0 && c0 < d0) {
        o = *reinterpret_cast<const uint4*>(h0 + r * d0 + c0);
      } else if (vec1 && k0 >= 0 && k0 < d1) {
        o = *reinterpret_cast<const uint4*>(h1 + r * d1 + k0);
      } else if (c0 < d0 + d1) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = c0 + e, k = k0 + e;
          const uint32_t v0 = h0[r * d0 + max(min(c, d0 - 1), 0)];
          const uint32_t v1 = h1[r * d1 + max(min(k, d1 - 1), 0)];
          w[e >> 1] |= (c < d0 ? v0 : (k < d1 ? v1 : 0u)) << (16 * (e & 1));
        }
        o = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(tile + sw_off(r, c0)) = o;
  }
}

// K8/K9: the IDE block of the tile (trunk_common.cuh `ide_fill`) from its
// raw inputs staged in shared memory, g [kRows][3], v [kRows][3] (geo), k
// [kRows]; four threads a row.
__device__ void ide_fill_staged(const Tile& t, const DirIn& d, const float* g, const float* v,
                                const float* k, int d0, int rows) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  DirSample s{};
  s.live = r < rows;
  if (s.live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.g[c] = g[r * 3 + c];
      s.v[c] = d.geo ? v[r * 3 + c] : 0.f;
      s.rd[c] = s.g[c];
    }
    s.ki = k[r];
    if (d.geo) dir_geometry(s.g, s.v, s.rd, s.nd, s.q);
  }
  for (int i = q; i < d.p; i += 4) {
    const Harm h = ide_harmonic(d, s.rd[0], s.rd[1], s.rd[2], i);
    const float zpat = h.zp * expf(mul(-s.ki, __ldg(d.sg + i)));
    t(r, d0 + i) = from_f<bf16>(s.live ? h.re * zpat : 0.f);
    t(r, d0 + d.p + i) = from_f<bf16>(s.live ? h.im * zpat : 0.f);
  }
  if (d.geo && q == 0) t(r, d0 + 2 * d.p) = from_f<bf16>(s.live ? s.nd : 0.f);
}

// K7: the input tile (trunk_common.cuh `load_ipe`) from lm, lv staged in
// shared memory: q's lm, lv point there, [kRows][nb] each, and its rows are
// the tile's. Columns [xs F | xc F], zeros past them and past `rows`.
__device__ void ipe_fill_staged(const Tile& t, const Ipe& q, int F, int kp, int rows) {
  for (int i = threadIdx.x; i < kRows * F; i += kCons) {
    const int r = i / F, c = i - r * F;
    float e = 0.f, sn = 0.f, cs = 0.f;
    if (r < rows) ipe_trig(q, r, c, e, sn, cs);
    t(r, c) = from_f<bf16>(mul(e, sn));
    t(r, F + c) = from_f<bf16>(mul(e, cs));
  }
  const int pad = kp - 2 * F;
  for (int i = threadIdx.x; i < kRows * pad; i += kCons) {
    const int r = i / pad;
    t(r, 2 * F + i - r * pad) = from_f<bf16>(0.f);
  }
}

// K3 on one tile (the consumers; act, inb its tiles, acc its accumulators,
// ut an f32 [kRows][kin] tile): the chain s_{L-1} = relu'(h) cdt(wd),
// s_{l-1} = relu'(h_{l-1}) cdt(s_l Wa_l), with u_x = s_skip Wx_skip + s_0
// Wx_0 in f32; then the fold u = (f32(xc) u_xs - f32(xs) u_xc) S (K7: e
// (cos m u_xs - sin m u_xc) S).
template <bool SPA>
__device__ __forceinline__ void chain(const FwdParams& p, float (&acc)[1][64], unsigned char* act,
                                      unsigned char* inb, const uint2* masks, const float* xst,
                                      float* ut, int row0, int rows, Ring& ring_st PHASE_PARAM) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7, w4 = warp & 3;
  const int fr = 16 * w4 + (lane >> 2), fc = 128 * wg + 2 * (lane & 3);
  const Tile X{inb};
  const uint32_t act_s[1] = {smem_u32(act)};
  auto publish = [&]() {
    fence_async_smem();
    cons_sync();
  };
  auto put2 = [&](int r, int c, uint32_t v) {
    *reinterpret_cast<uint32_t*>(act + sw_off(r, c)) = v;
  };
  cons_sync();  // the bottleneck head's product has read y
  {
    const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = fc + 8 * j;
      const float q0 = round_t<bf16>(p.wd[c]), q1 = round_t<bf16>(p.wd[c + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        put2(fr + 8 * h, c, bits2(__floats2bfloat162_rn(bit_at(mk, i) ? q0 : 0.f,
                                                         bit_at(mk, i + 1) ? q1 : 0.f)));
      }
    }
  }
  publish();
  PHASE_MARK(3, kScal);
  // u_x = s_skip Wx_skip + s_0 Wx_0 in f32 in the [kRows][kin] tile ut, in
  // trunk_fwd.cu's order, each product's share as it comes out of acc (no
  // second set of accumulators lives through the chain).
  auto take_ux = [&](bool first) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = fc + 8 * j, i = 4 * j + 2 * h;
        if (c >= p.kin) continue;
        float2* q = reinterpret_cast<float2*>(ut + (fr + 8 * h) * p.kin + c);
        const float2 o = first ? make_float2(0.f, 0.f) : *q;
        *q = make_float2(o.x + acc[0][i], o.y + acc[0][i + 1]);
      }
  };
  for (int l = p.depth - 1; l > 0; --l) {
    if (l == p.skip) {
      product_n<1>(acc, act_s, kW / 64, act_s, kW, ring_st);
      take_ux(true);
    }
    product_n<1>(acc, act_s, kW / 64, act_s, kW, ring_st);
    PHASE_MARK(3, kProd);
    cons_sync();
    const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // cdt(acc) on bf16 pairs, masked by the two relu' bits.
        const int i = 4 * j + 2 * h;
        const uint32_t b = ((i < 32 ? mk.x >> i : mk.y >> (i - 32)) & 3u);
        const uint32_t keep = ((0u - (b & 1u)) & 0xffffu) | ((0u - (b >> 1)) & 0xffff0000u);
        put2(fr + 8 * h, fc + 8 * j,
             bits2(__floats2bfloat162_rn(acc[0][i], acc[0][i + 1])) & keep);
      }
    publish();
    PHASE_MARK(3, kScal);
  }
  product_n<1>(acc, act_s, kW / 64, act_s, kW, ring_st);
  take_ux(p.skip <= 0);
  PHASE_MARK(3, kProd);

  // The fold, as trunk_fwd.cu: u_m in place of u_xs, then u = u_m S, a
  // thread a (row, basis vector).
  const int F = p.d0, nb = p.nb;
  bool k7 = false;
  if constexpr (SPA) k7 = p.ipe.lm != nullptr;
  cons_sync();
  for (int i = tid; i < kRows * F; i += kCons) {
    const int r = i / F, c = i % F;
    if (r >= rows) continue;
    float* u0 = ut + r * p.kin + c;
    if (k7) {  // e (cos m u_xs - sin m u_xc) in f32 (:657-659), lm, lv staged
      float e, sn, cs;
      ipe_trig(Ipe{xst, xst + kRows * nb, p.fold, nb}, r, c, e, sn, cs);
      *u0 = mul(e, sub(mul(cs, u0[0]), mul(sn, u0[F])));
    } else {  // f32(xc) u_xs - f32(xs) u_xc
      *u0 = to_f(X(r, F + c)) * u0[0] - to_f(X(r, c)) * u0[F];
    }
  }
  cons_sync();
  for (int i = tid; i < kRows * nb; i += kCons) {
    const int r = i / nb, j = i % nb, gr = row0 + r;
    if (gr >= p.n) continue;
    float s = 0.f;
    for (int c = 0; c < F; ++c) s = fmaf(ut[r * p.kin + c], p.fold[c * nb + j], s);
    p.u[static_cast<size_t>(gr) * nb + j] = s;
  }
  PHASE_MARK(3, kScal);
}

// ---------------------------------------------------------------------------
// Width 128: mip-NeRF's plain directional trunk (K2 at width 128: the f32
// heads, no density head, bottleneck, fused stage or y). A unit is two
// 64-sample tiles, and warpgroup g runs tile g on the whole [128][64] weight
// slice (`product<128>`, hopper_tma.cuh) with the same 64 accumulators a
// thread, now at row 16 w + lane / 4 + 8 h and column 8 j + 2 (lane % 4) + e
// of its own tile, and the same epilogue: each 16 KB slice feeds both tiles.
// The warpgroups share only the ring: each fills and multiplies its own
// tile between barriers of its own 128 threads (`wg_sync`), and its next
// unit's segments land in its staging buffer by cp.async during this
// unit's products, so no load's latency waits in line with the tensor
// cores. A row's 128 columns lie in one quad, so the f32 heads' dot
// products are summed over its 4 lanes by shuffles and leave from
// registers.

// The barrier of one consumer warpgroup's 128 threads (ids 2 and 3;
// cons_sync is 1).
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + (threadIdx.x >> 7)) : "memory");
}

// A tile's rows [row0, row0 + rows) of a [n][d] segment to `st`, as
// stage_block, by one warpgroup's 128 threads, but 16 bytes a cp.async that
// lands while the thread goes on (where the block is 16-byte aligned; the
// rest by plain loads). cp_wait then waits for the thread's copies.
__device__ void stage_async(bf16* st, const bf16* x, int d, int row0, int rows) {
  if (x == nullptr || d == 0) return;
  const int tid = threadIdx.x & 127;
  const bf16* src = x + static_cast<size_t>(row0) * d;
  const int count = rows * d;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int nv = count >> 3;
    for (int i = tid; i < nv; i += 128)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(st + 8 * i)),
                   "l"(src + 8 * i)
                   : "memory");
    done = nv << 3;
  }
  for (int i = done + tid; i < count; i += 128) st[i] = src[i];
}
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

template <int W>
__device__ __forceinline__ void fwd_two_tiles(const FwdParams& p, const FwdMaps& m,
                                              unsigned char* smem) {
  constexpr int ActB = (W / 64) * kBlk;
  const int kp = (p.kin + kBK - 1) / kBK * kBK, InB = (kp / 64) * kBlk;
  const int StB = 2 * kRows * (p.d0 + p.d1);  // bytes of a tile's raw segments
  const int stages = m.stages;
  const int units = (p.n + 2 * kRows - 1) / (2 * kRows);
  unsigned char* ring = smem;                        // stages x [W][64]
  unsigned char* act0 = ring + stages * kSliceW<W>;  // 2 x [64][W]: h_l
  unsigned char* inb0 = act0 + 2 * ActB;             // 2 x [64][kp]: the trunk input
  unsigned char* stg0 = inb0 + 2 * InB;              // 2 x [64][d0 | d1]: the segments
  float* hw = reinterpret_cast<float*>(stg0 + 2 * StB);  // [hf][W]: wh, where it fits
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(hw + (m.heads_in_smem ? p.hf * W : 0)) + 7) &
      ~static_cast<uintptr_t>(7));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ring_st{smem_u32(ring), smem_u32(bars), smem_u32(bars + stages), stages, 0, 0u};

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring_st.full + 8 * s, 1);
      mbar_init(ring_st.empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kCons / 32) {  // the producer: each unit's layers, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProdRegs));
    if (warp == kCons / 32 && lane == 0)
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x)
        for (int l = 0; l < p.depth; ++l)
          for (int k = 0; k < k_dim<W>(p, l); k += kBK) {
            mbar_wait(ring_st.empty + 8 * ring_st.stage, ring_st.phase ^ 1u);
            mbar_expect_tx(ring_st.full + 8 * ring_st.stage, kSliceW<W>);
            tma_load(ring_st.base + ring_st.stage * kSliceW<W>, &m.w[l],
                     ring_st.full + 8 * ring_st.stage, k, 0);
            ring_st.advance();
          }
    return;
  }

  // The consumers: warpgroup wg runs tile wg of each unit.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsRegs));
  PHASE_START;
  const int wg = tid >> 7, w4 = warp & 3;
  const int fr = 16 * w4 + (lane >> 2);  // acc[4 j + 2 h + e]: row fr + 8 h,
  const int fc = 2 * (lane & 3);         // column fc + 8 j + e
  unsigned char* act = act0 + wg * ActB;
  unsigned char* inb = inb0 + wg * InB;
  bf16* stg = reinterpret_cast<bf16*>(stg0 + wg * StB);
  const uint32_t act_s = smem_u32(act), inb_s = smem_u32(inb);
  const bf16* bias = static_cast<const bf16*>(p.b);
  const float* whp = p.wh;
  if (m.heads_in_smem) {  // the f32 heads' weights, once a CTA
    for (int i = tid; i < p.hf * W; i += kCons) hw[i] = p.wh[i];
    whp = hw;
  }
  // A unit's segments, staged for this warpgroup's tile while the unit
  // before it runs its products.
  auto prefetch = [&](int unit) {
    const int row0 = (2 * unit + wg) * kRows, rows = max(0, min(kRows, p.n - row0));
    stage_async(stg, static_cast<const bf16*>(p.x0), p.d0, row0, rows);
    stage_async(stg + kRows * p.d0, static_cast<const bf16*>(p.x1), p.d1, row0, rows);
  };
  if (blockIdx.x < units) prefetch(blockIdx.x);
  cons_sync();
  float acc[64];

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    // The last unit's reads of the tiles (the products) ended before
    // barriers of this warpgroup.
    const int row0 = (2 * unit + wg) * kRows, rows = max(0, min(kRows, p.n - row0));

    // 1. The input tile from its segments, staged during the last unit; then
    // the next unit's staging starts.
    cp_wait();
    wg_sync();
    fill_chunks<128>(inb, stg, p.d0, stg + kRows * p.d0, p.d1, kp, rows);
    fence_async_smem();
    wg_sync();
    if (unit + gridDim.x < units) prefetch(unit + gridDim.x);
    PHASE_MARK(0, kScal);

    // 2. The layers: h_l = relu(cdt(cdt(acc) + b_l)) on bf16 pairs to the
    // activation tile (but the last, y) and kept in acc.
    for (int l = 0; l < p.depth; ++l) {
      if (l == 0)
        product<W>(acc, inb_s, kp / 64, inb_s, p.kin, ring_st);
      else
        product<W>(acc, act_s, W / 64, inb_s, k_dim<W>(p, l), ring_st);
      PHASE_MARK(1, kProd);
      wg_sync();  // the warpgroup's product has read its tiles
      const bool keep = l + 1 < p.depth;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = fc + 8 * j;
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + l * W + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const uint32_t v = bits2(__hmax2(
              __hadd2(__floats2bfloat162_rn(acc[i], acc[i + 1]), bb), __float2bfloat162_rn(0.f)));
          if (keep) *reinterpret_cast<uint32_t*>(act + sw_off(fr + 8 * h, c)) = v;
          acc[i] = __uint_as_float(v << 16);
          acc[i + 1] = __uint_as_float(v & 0xffff0000u);
        }
      }
      fence_async_smem();
      wg_sync();
      PHASE_MARK(1, kScal);
    }

    // 3. The f32 heads f32(y) wh^T + bh: the thread's 32 columns of its two
    // rows, summed over the quad, stored by its first lane.
    for (int k = 0; k < p.hf; ++k) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(whp + k * W + fc + 8 * j);
        s0 = fmaf(acc[4 * j], w.x, s0);
        s0 = fmaf(acc[4 * j + 1], w.y, s0);
        s1 = fmaf(acc[4 * j + 2], w.x, s1);
        s1 = fmaf(acc[4 * j + 3], w.y, s1);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if ((lane & 3) == 0) {
        const float b = p.bh[k];
        if (fr < rows) p.hout[static_cast<size_t>(row0 + fr) * p.hf + k] = s0 + b;
        if (fr + 8 < rows) p.hout[static_cast<size_t>(row0 + fr + 8) * p.hf + k] = s1 + b;
      }
    }
    PHASE_MARK(2, kStore);
  }
}

// K3 on the wide-input instance: the u_x columns [c0, c0 + 256) of the
// trunk input that one product left in the accumulators (column c0 + fc +
// 8 j + e of row fr + 8 h in a[4 j + 2 h + e]), folded onto the lifted
// means at once: a sin column c adds f32(xc) u_x S[c] to u, a cos column
// d0 + c adds -f32(xs) u_x S[c] (u_m = f32(xc) u_xs - f32(xs) u_xc, then u =
// u_m S, :653-662), the partner segment's values read from device memory,
// a column pair a load (d0 even). S is staged in shared memory, fs [d0][nbp]
// (rows padded to nbp, a multiple of 8, with zeros): a quad's 4 lanes read 4
// rows, the warp's 8 row groups the same 4, two 16-byte loads a column and 8
// basis vectors. The thread's sums over its 32 columns, then over its
// quad's 4 lanes, go to ust [warpgroup][kRows][nb], 8 basis vectors a pass;
// the caller adds the two warpgroups' in order. a is left scaled.
__device__ __forceinline__ void fold_ux(float (&a)[64], int c0, int fr, int fc, int row0,
                                        const FwdParams& p, const float* fs, int nbp,
                                        float* ust PHASE_PARAM) {
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, F = p.d0, nb = p.nb;
  const bf16* x0 = static_cast<const bf16*>(p.x0);
  const bf16* x1 = static_cast<const bf16*>(p.x1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + fr + 8 * h;
    const size_t o = static_cast<size_t>(gr) * F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // Columns k and k + 1 (k even) lie in one segment, d0 being even.
      const int k = c0 + fc + 8 * j;
      float2 cf = make_float2(0.f, 0.f);
      if (gr < p.n && k < 2 * F) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            k < F ? x1 + o + k : x0 + o + (k - F));
        cf = k < F ? make_float2(to_f(v.x), to_f(v.y)) : make_float2(-to_f(v.x), -to_f(v.y));
      }
      a[4 * j + 2 * h] *= cf.x;
      a[4 * j + 2 * h + 1] *= cf.y;
    }
  }
  PHASE_MARK(5, kScal);  // the partner loads and the scaling
  for (int jb = 0; jb < nbp; jb += 8) {
    float s[2][8];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[0][t] = s[1][t] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // Past the segments a is 0: any fold row serves.
        const int k = c0 + fc + 8 * j + e, c = k < F ? k : min(k - F, F - 1);
        const float4* f4 = reinterpret_cast<const float4*>(fs + c * nbp + jb);
        const float4 f0 = f4[0], f1 = f4[1];
        const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          s[0][t] = fmaf(a[4 * j + e], f[t], s[0][t]);
          s[1][t] = fmaf(a[4 * j + 2 + e], f[t], s[1][t]);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        s[h][t] += __shfl_xor_sync(0xffffffffu, s[h][t], 1);
        s[h][t] += __shfl_xor_sync(0xffffffffu, s[h][t], 2);
      }
    if ((lane & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (jb + t < nb) ust[(wg * kRows + fr + 8 * h) * nb + jb + t] = s[h][t];
  }
}

// ---------------------------------------------------------------------------
// The wide-input instance (WIDE): the spatial trunk at width 256 on more
// than kW and at most kWideKin input columns, with sigma and the f32 heads
// (the bottleneck and K3: HC and NT below; no fused stage or y): mip-NeRF
// 360's proposal MLP, 504 IPE columns (kin 512 packed). The body above stages a
// tile's raw segments in its activation tile and keeps the whole input
// tile: at 512 columns that is 64.5 KB of staging and 64 KB of input a
// tile, past shared memory at two tiles a CTA (NT = 2). Here, two tiles a
// CTA, layer 0's input, and the skip layer's input share, stream in chunks
// of CW = 128 columns through slots of two tiles: two buffers (64 KB, what a
// 256-column instance's input tiles take) and, at layer 0, the activation
// tiles too (free until its epilogue). A chunk's 8-byte cp.asyncs land straight in the swizzled
// layout (`wide_chunk`) while the chunks before it run their products,
// which sum into the accumulators (`product_n` with `acc_in`): at layer 0
// the next three chunks are in flight (all four of 512 columns), at the
// skip layer the next one. The next pass's first chunk (the skip
// layer's, or the next unit's layer 0) lands during the layers between, and
// the f32 heads' partial sums use buffer 1, idle from the last pass to the
// next unit's. The producer walks the same `schedule` as the body above:
// ceil(K / 64) slices a layer, in the order the chunks take them. The
// layers' and heads' epilogues are the body's (K1's arithmetic and
// roundings). One tile a CTA (256-column chunks, a 3-stage ring) ran the
// PropMLP's trunk ~26% slower than two (PERF.md).
//
// HC: the compute-dtype head (128 or 256 wide: the MLP's bottleneck), one
// more product of the ring after the layers on y, which the last layer then
// leaves in the activation tiles; stored from its accumulators as the body
// stores it. NT = 1: K3, one tile at a time (its relu' bits, 16 KB a tile at
// depth 8, and its chain's state do not fit twice). The chain runs as the
// body's, but u_x never lies whole in shared memory (a [64][512] f32 tile is
// 128 KB): its products come 256 input columns at a time, and each one's
// columns are folded at once into u [64][nb] f32 (`fold_ux`), the partner
// segment's values (xc for a sin column, -xs for a cos one) read from the
// inputs in device memory.
template <int HC, int NT>
__device__ __forceinline__ void fwd_wide(const FwdParams& p, const FwdMaps& m,
                                         unsigned char* smem) {
  constexpr int CW = kW / 2, ChB = (CW / 64) * kBlk;  // a chunk: columns, bytes
  constexpr bool DG = NT == 1;                         // K3
  const int kp = (p.kin + kBK - 1) / kBK * kBK, nc = (kp + CW - 1) / CW;
  const int stages = m.stages, units = (p.n + NT * kRows - 1) / (NT * kRows);
  const int nred = max(1 + p.hf, 4);
  const bool skip = p.skip > 0 && p.skip < p.depth;
  unsigned char* ring = smem;                         // stages x [256][64]
  unsigned char* act0 = ring + stages * kSlice;       // NT x [64][256]: h_l (K3: then s_l)
  unsigned char* buf0 = act0 + NT * (kW / 64) * kBlk;  // 2 x NT x [64][CW]: input chunks
  uint2* masks = reinterpret_cast<uint2*>(buf0 + 2 * NT * ChB);  // K3: [depth][256]
  float* ut = reinterpret_cast<float*>(masks + (DG ? p.depth * kCons : 0));  // K3: u [kRows][nb]
  float* ust = ut + (DG ? kRows * p.nb : 0);  // K3: a product's u, [2 warpgroups][kRows][nb]
  const int nbp = (p.nb + 7) & ~7;
  float* fs = ust + (DG ? 2 * kRows * p.nb : 0);  // K3: the fold S, [d0][nbp]
  float* hw = DG ? fs + p.d0 * nbp
                 : reinterpret_cast<float*>(buf0 + 2 * NT * ChB);  // [1 + hf][256], where they fit
  float* red0 = reinterpret_cast<float*>(buf0 + NT * ChB);    // NT x [2][kRows][nred]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(hw + (m.heads_in_smem ? (1 + p.hf) * kW : 0)) + 7) &
      ~static_cast<uintptr_t>(7));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ring_st{smem_u32(ring), smem_u32(bars), smem_u32(bars + stages), stages, 0, 0u};

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring_st.full + 8 * s, 1);
      mbar_init(ring_st.empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kCons / 32) {  // the producer: weight slices, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProdRegs));
    if (warp == kCons / 32 && lane == 0)
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x)
        if constexpr (DG) {
          schedule_wide<HC>(p, m, [&](const CUtensorMap* map, int row, int K) {
            for (int k = 0; k < K; k += kBK) {
              mbar_wait(ring_st.empty + 8 * ring_st.stage, ring_st.phase ^ 1u);
              mbar_expect_tx(ring_st.full + 8 * ring_st.stage, kSlice);
              tma_load(ring_st.base + ring_st.stage * kSlice, map,
                       ring_st.full + 8 * ring_st.stage, k, row);
              ring_st.advance();
            }
          });
        } else {
          schedule<HC>(p, m, [&](const CUtensorMap* map, int row, int K) {
            for (int k = 0; k < K; k += kBK) {
              mbar_wait(ring_st.empty + 8 * ring_st.stage, ring_st.phase ^ 1u);
              mbar_expect_tx(ring_st.full + 8 * ring_st.stage, kSlice);
              tma_load(ring_st.base + ring_st.stage * kSlice, map,
                       ring_st.full + 8 * ring_st.stage, k, row);
              ring_st.advance();
            }
          });
        }
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsRegs));
  PHASE_START;
  const int wg = tid >> 7, w4 = warp & 3;
  const int fr = 16 * w4 + (lane >> 2);      // acc[t][4 j + 2 h + e]: row fr + 8 h,
  const int fc = 128 * wg + 2 * (lane & 3);  // column fc + 8 j + e
  const bf16* bias = static_cast<const bf16*>(p.b);
  const bf16* x0 = static_cast<const bf16*>(p.x0);
  const bf16* x1 = static_cast<const bf16*>(p.x1);
  auto act = [&](int t) { return act0 + t * (kW / 64) * kBlk; };
  auto buf = [&](int b, int t) { return buf0 + (b * NT + t) * ChB; };
  // Slot k of tile t's chunk: the two buffers, then the activation tiles.
  auto slot = [&](int k, int t) { return k < 2 ? buf(k, t) : act0 + ((k - 2) * NT + t) * ChB; };
  uint32_t act_s[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) act_s[t] = smem_u32(act(t));
  const float* wdp = p.wd;
  const float* whp = p.wh;
  if (m.heads_in_smem) {  // the f32 heads' weights, once a CTA
    for (int i = tid; i < (1 + p.hf) * kW; i += kCons)
      hw[i] = i < kW ? (p.wd != nullptr ? p.wd[i] : 0.f) : p.wh[i - kW];
    wdp = hw;
    whp = hw + kW;
  }
  if constexpr (DG)  // the fold, once a CTA, its rows padded with zeros
    for (int i = tid; i < p.d0 * nbp; i += kCons) {
      const int c = i / nbp, j = i - c * nbp;
      fs[i] = j < p.nb ? p.fold[c * p.nb + j] : 0.f;
    }
  float acc[NT][64];

  // Chunk c of unit `unit`'s tiles in flight to slot k (one cp.async
  // group a thread).
  auto issue = [&](int unit, int c, int k) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int row0 = (unit * NT + t) * kRows;
      wide_chunk<CW>(slot(k, t), x0, p.d0, x1, p.d1, c * CW, min(CW, kp - c * CW), row0,
                     max(0, min(kRows, p.n - row0)), tid, kCons);
    }
    cp_async_commit();
  };
  // acc (+)= the input share of a layer, chunk by chunk through S slots
  // (chunk c in slot c % S, the next S - 1 in flight during its products);
  // chunk 0 is in flight at entry.
  auto input_share = [&](int unit, int acc_in, int S) {
    int issued = 1;
    for (int c = 0; c < nc; ++c) {
      // A slot's last products ended before a barrier.
      for (; issued < min(nc, c + S); ++issued) issue(unit, issued, issued % S);
      cp_async_wait_upto(issued - 1 - c);
      fence_async_smem();
      cons_sync();
      PHASE_MARK(0, kScal);
      uint32_t a[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) a[t] = smem_u32(slot(c % S, t));
      product_n<NT>(acc, a, CW / 64, a, min(CW, p.kin - c * CW), ring_st, acc_in | c);
      cons_sync();  // both warpgroups' products have read the chunk
      PHASE_MARK(1, kProd);
    }
  };

  if (blockIdx.x < units) issue(blockIdx.x, 0, 0);
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    int row0[NT], rows[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      row0[t] = (unit * NT + t) * kRows;
      rows[t] = max(0, min(kRows, p.n - row0[t]));
    }
    const int next = unit + gridDim.x;
    cons_sync();  // the last unit's reads of every tile and buffer are done

    // The layers: h_l = relu(cdt(cdt(acc) + b_l)) on bf16 pairs to the
    // activation tiles (but the last, y) and kept in acc.
    for (int l = 0; l < p.depth; ++l) {
      if (l == 0 || l == p.skip) {
        if (l > 0) product_n<NT>(acc, act_s, kW / 64, act_s, kW, ring_st);  // [h | x]: h first
        input_share(unit, l > 0, l > 0 ? 2 : 4);
        // The next pass's first chunk: the skip layer's, or the next unit's.
        if (l == 0 && skip)
          issue(unit, 0, 0);
        else if (next < units)
          issue(next, 0, 0);
      } else {
        product_n<NT>(acc, act_s, kW / 64, act_s, kW, ring_st);
        PHASE_MARK(1, kProd);
        cons_sync();  // both warpgroups' products have read the tiles
      }
      const bool keep = l + 1 < p.depth || HC > 0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        [[maybe_unused]] uint32_t mk[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = fc + 8 * j;
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + l * kW + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            const uint32_t v = bits2(__hmax2(
                __hadd2(__floats2bfloat162_rn(acc[t][i], acc[t][i + 1]), bb),
                __float2bfloat162_rn(0.f)));
            if constexpr (DG) {
              mk[i >> 5] |= ((v & 0x7fffu) != 0u ? 1u : 0u) << (i & 31);
              mk[i >> 5] |= ((v & 0x7fff0000u) != 0u ? 1u : 0u) << ((i + 1) & 31);
            }
            if (keep) *reinterpret_cast<uint32_t*>(act(t) + sw_off(fr + 8 * h, c)) = v;
            acc[t][i] = __uint_as_float(v << 16);
            acc[t][i + 1] = __uint_as_float(v & 0xffff0000u);
          }
        }
        if constexpr (DG) masks[l * kCons + tid] = make_uint2(mk[0], mk[1]);
      }
      fence_async_smem();
      cons_sync();
      PHASE_MARK(1, kScal);
    }

    // sigma = f32(y) wd and the f32 heads f32(y) wh^T + bh from the
    // registers, the two warpgroups' halves summed by a thread an output.
    const int nh = 1 + p.hf;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float* rw = red0 + (t * 2 + wg) * kRows * nred;
      if (p.wd != nullptr) head_part(acc[t], wdp, fc, fr, rw, nred, 0);
      for (int k = 0; k < p.hf; ++k) head_part(acc[t], whp + k * kW, fc, fr, rw, nred, 1 + k);
    }
    cons_sync();
    for (int t = 0; t < NT; ++t) {
      const float* rd = red0 + t * 2 * kRows * nred;
      for (int i = tid; i < rows[t] * nh; i += kCons) {
        const int r = i / nh, k = i - r * nh;
        const size_t gr = static_cast<size_t>(row0[t] + r);
        const float s = rd[r * nred + k] + rd[(kRows + r) * nred + k];
        if (k == 0) {
          if (p.wd != nullptr) p.sig[gr] = s;
        } else {
          p.hout[gr * p.hf + k - 1] = s + p.bh[k - 1];
        }
      }
    }
    PHASE_MARK(2, kStore);

    // The bottleneck head hc = cdt(y wc^T) + cdt(bc) from its accumulators,
    // as the body's step 4.
    if constexpr (HC > 0) {
      product_n<NT>(acc, act_s, kW / 64, act_s, kW, ring_st);
      PHASE_MARK(2, kProd);
      if (128 * wg < HC) {
        const bf16* bc = static_cast<const bf16*>(p.bc);
        bf16* out = static_cast<bf16*>(p.cout);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = fc + 8 * j;
            if (c >= HC) continue;
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bc + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int gr = row0[t] + fr + 8 * h, i = 4 * j + 2 * h;
              if (gr < p.n)
                *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(gr) * HC + c) =
                    __floats2bfloat162_rn(bias_add<bf16>(acc[t][i], bb.x),
                                          bias_add<bf16>(acc[t][i + 1], bb.y));
            }
          }
      }
      PHASE_MARK(2, kStore);
    }

    // K3: the chain s_{L-1} = relu'(h) cdt(wd), s_{l-1} = relu'(h_{l-1})
    // cdt(s_l Wa_l), as the body's `chain`; each u_x product (256 input
    // columns of the skip layer's, then of layer 0's) folded at once into ut.
    if constexpr (DG) {
      auto put2 = [&](int r, int c, uint32_t v) {
        *reinterpret_cast<uint32_t*>(act0 + sw_off(r, c)) = v;
      };
      auto publish = [&]() {
        fence_async_smem();
        cons_sync();
      };
      cons_sync();  // the bottleneck head's product has read y
      for (int i = tid; i < kRows * p.nb; i += kCons) ut[i] = 0.f;
      {
        const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = fc + 8 * j;
          const float q0 = round_t<bf16>(p.wd[c]), q1 = round_t<bf16>(p.wd[c + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            put2(fr + 8 * h, c, bits2(__floats2bfloat162_rn(bit_at(mk, i) ? q0 : 0.f,
                                                             bit_at(mk, i + 1) ? q1 : 0.f)));
          }
        }
      }
      publish();
      PHASE_MARK(3, kScal);
      // u_x of one layer's input columns, 256 a product, each folded.
      auto take_ux = [&]() {
        for (int c0 = 0; c0 < p.kin; c0 += kW) {
          product_n<1>(acc, act_s, kW / 64, act_s, kW, ring_st);
          PHASE_MARK(3, kProd);
          fold_ux(acc[0], c0, fr, fc, row0[0], p, fs, nbp, ust PHASE_ARG);
          PHASE_MARK(6, kScal);  // the fold's FMA passes and shuffles
          cons_sync();
          for (int i = tid; i < kRows * p.nb; i += kCons)
            ut[i] += ust[i] + ust[kRows * p.nb + i];
          cons_sync();
          PHASE_MARK(6, kStore);  // the two warpgroups' sums into u
        }
      };
      for (int l = p.depth - 1; l > 0; --l) {
        if (l == p.skip) take_ux();
        product_n<1>(acc, act_s, kW / 64, act_s, kW, ring_st);
        PHASE_MARK(3, kProd);
        cons_sync();
        const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // cdt(acc) on bf16 pairs, masked by the two relu' bits.
            const int i = 4 * j + 2 * h;
            const uint32_t b = ((i < 32 ? mk.x >> i : mk.y >> (i - 32)) & 3u);
            const uint32_t kp2 = ((0u - (b & 1u)) & 0xffffu) | ((0u - (b >> 1)) & 0xffff0000u);
            put2(fr + 8 * h, fc + 8 * j,
                 bits2(__floats2bfloat162_rn(acc[0][i], acc[0][i + 1])) & kp2);
          }
        publish();
        PHASE_MARK(3, kScal);
      }
      take_ux();
      for (int i = tid; i < rows[0] * p.nb; i += kCons)
        p.u[static_cast<size_t>(row0[0]) * p.nb + i] = ut[i];
      PHASE_MARK(3, kStore);
    }
  }
}

// YO: K11, y stored from the registers after the last layer. W: the
// trunk width, 256, or 128 for the plain directional trunk alone
// (`fwd_two_tiles`; the rest of this body is width 256's).
template <int HC, bool DIR, bool SPA, int NT, bool YO = false, int W = kW, bool WIDE = false>
__global__ void __launch_bounds__(kFwdThreads, 1)
    trunk_fwd_tma_kernel(const __grid_constant__ FwdParams p, const __grid_constant__ FwdMaps m) {
  static_assert(W == kW || (HC == 0 && !DIR && !SPA && !YO), "width 128: the plain K2 alone");
  static_assert(!YO || (HC == 0 && !DIR && !SPA && NT == 2), "K11: the spatial trunk alone");
  static_assert(!WIDE || (W == kW && (HC == 0 || HC == 128 || HC == 256) && !DIR && !SPA && !YO),
                "wide: sigma, f32 heads, the bottleneck; K3 one tile at a time");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if constexpr (W != kW) {
    fwd_two_tiles<W>(p, m, smem);
    return;
  }
  if constexpr (WIDE) {
    fwd_wide<HC, NT>(p, m, smem);
    return;
  }
  const int kp = (p.kin + kBK - 1) / kBK * kBK;
  const bool dg = NT == 1 && p.u != nullptr;
  const int tiles = m.tiles, stages = m.stages;
  const int units = (p.n + tiles * kRows - 1) / (tiles * kRows);
  const int nred = max(1 + p.hf, 4);
  unsigned char* ring = smem;                      // stages x [256][64]
  unsigned char* act0 = ring + stages * kSlice;    // NT x [64][256]: h_l, then K3's s_l
  unsigned char* inb0 = act0 + NT * (kW / 64) * kBlk;  // NT x [64][kp]: the trunk input
  uint2* masks = reinterpret_cast<uint2*>(inb0 + NT * (kp / 64) * kBlk);  // K3: [depth][256]
  // Without the bottleneck head a tile's activations are dead from its
  // last product to its next input, and its raw inputs' staging uses the
  // front of it: there (small_in_act) xst lives at its end and red at its
  // front, which buys the directional trunk a third stage of the ring.
  const bool in_act = m.small_in_act;
  float* xst0 = reinterpret_cast<float*>(masks + (dg ? p.depth * kCons : 0));  // NT x [kXst]
  float* hw = xst0 + (in_act ? 0 : NT * kXst);  // [1 + hf][W]: wd (or zeros), wh, where they fit
  float* red0 = hw + (m.heads_in_smem ? (1 + p.hf) * kW : 0);  // NT x [2][kRows][nred]
  float* ut = red0 + (in_act ? 0 : NT * 2 * kRows * nred);  // K3: u_x [kRows][kin] f32
  float* sraw = ut + (dg ? kRows * p.kin : 0);  // K6: the
  const int nsraw = SPA && p.wts != nullptr ? tiles * kRows : 0;  // unit's raw density
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(sraw + nsraw) + 7) & ~static_cast<uintptr_t>(7));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ring_st{smem_u32(ring), smem_u32(bars), smem_u32(bars + stages), stages, 0, 0u};
  auto act = [&](int t) { return act0 + t * (kW / 64) * kBlk; };
  auto inb = [&](int t) { return inb0 + t * (kp / 64) * kBlk; };
  auto xst = [&](int t) {
    return in_act ? reinterpret_cast<float*>(act(t) + (kW / 64) * kBlk) - kXst : xst0 + t * kXst;
  };
  auto red = [&](int t) {
    return in_act ? reinterpret_cast<float*>(act(t)) : red0 + t * 2 * kRows * nred;
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring_st.full + 8 * s, 1);
      mbar_init(ring_st.empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kCons / 32) {  // the producer: weight slices, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProdRegs));
    if (warp == kCons / 32 && lane == 0) {
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x)
        for (int t = 0; t < tiles; t += NT)
          schedule<HC>(p, m, [&](const CUtensorMap* map, int row, int K) {
            for (int k = 0; k < K; k += kBK) {
              mbar_wait(ring_st.empty + 8 * ring_st.stage, ring_st.phase ^ 1u);
              mbar_expect_tx(ring_st.full + 8 * ring_st.stage, kSlice);
              tma_load(ring_st.base + ring_st.stage * kSlice, map,
                       ring_st.full + 8 * ring_st.stage, k, row);
              ring_st.advance();
            }
          });
    }
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsRegs));
  PHASE_START;
  const int wg = tid >> 7, w4 = warp & 3;
  const int fr = 16 * w4 + (lane >> 2);      // acc[t][4 j + 2 h + e]: row fr + 8 h,
  const int fc = 128 * wg + 2 * (lane & 3);  // column fc + 8 j + e
  const bf16* bias = static_cast<const bf16*>(p.b);
  uint32_t act_s[NT], inb_s[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    act_s[t] = smem_u32(act(t));
    inb_s[t] = smem_u32(inb(t));
  }
  float acc[NT][64];

  // After the consumers wrote a tile: visible to wgmma.
  auto publish = [&]() {
    fence_async_smem();
    cons_sync();
  };
  auto put2 = [&](int t, int r, int c, uint32_t v) {
    *reinterpret_cast<uint32_t*>(act(t) + sw_off(r, c)) = v;
  };

  // The f32 heads' weights, once a CTA.
  const float* wdp = p.wd;
  const float* whp = p.wh;
  if (m.heads_in_smem) {
    for (int i = tid; i < (1 + p.hf) * kW; i += kCons)
      hw[i] = i < kW ? (p.wd != nullptr ? p.wd[i] : 0.f) : p.wh[i - kW];
    wdp = hw;
    whp = hw + kW;
  }

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    for (int tp = 0; tp < tiles; tp += NT) {
      int row0[NT], rows[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        row0[t] = (unit * tiles + tp + t) * kRows;
        rows[t] = max(0, min(kRows, p.n - row0[t]));
      }
      cons_sync();  // the last tiles' reads of every tile and buffer are done

      // 1. The input tiles, their raw inputs staged first with every load in
      // flight (the segments over the activation tiles; K7's lm, lv and K8's
      // directions in xst); K7 the IPE, K8/K9 the IDE block made here.
      bool ipe = false;
      if constexpr (SPA) ipe = p.ipe.lm != nullptr;
      if (ipe) {
        const int nb = p.ipe.nb;
        for (int t = 0; t < NT; ++t)
          for (int i = tid; i < rows[t] * nb; i += kCons) {
            xst(t)[i] = p.ipe.lm[static_cast<size_t>(row0[t]) * nb + i];
            xst(t)[kRows * nb + i] = p.ipe.lv[static_cast<size_t>(row0[t]) * nb + i];
          }
        cons_sync();
        for (int t = 0; t < NT; ++t)
          ipe_fill_staged(Tile{inb(t)}, Ipe{xst(t), xst(t) + kRows * nb, p.fold, nb}, p.d0, kp,
                          rows[t]);
      } else {
        const bool ide = DIR && p.dir.p != 0;
        for (int t = 0; t < NT; ++t) {
          bf16* s0 = reinterpret_cast<bf16*>(act(t));
          stage_block(s0, static_cast<const bf16*>(p.x0), p.d0, row0[t], rows[t]);
          stage_block(s0 + kRows * p.d0, static_cast<const bf16*>(p.x1), p.d1, row0[t], rows[t]);
          if (ide) {
            float* x = xst(t);
            for (int i = tid; i < rows[t] * 3; i += kCons) {
              x[i] = p.dir.g[static_cast<size_t>(row0[t]) * 3 + i];
              if (p.dir.geo) x[3 * kRows + i] = p.dir.v[static_cast<size_t>(row0[t]) * 3 + i];
            }
            for (int i = tid; i < rows[t]; i += kCons) x[6 * kRows + i] = p.dir.k[row0[t] + i];
          }
        }
        cons_sync();
        for (int t = 0; t < NT; ++t) {
          const bf16* s0 = reinterpret_cast<const bf16*>(act(t));
          if constexpr (YO)
            fill_chunks<kCons>(inb(t), s0, p.d0, s0 + kRows * p.d0, p.d1, kp, rows[t]);
          else
            fill_input(inb(t), s0, p.d0, s0 + kRows * p.d0, p.d1, DIR ? p.dir.width() : 0, kp,
                       rows[t]);
        }
        if constexpr (DIR) {
          if (ide) {
            cons_sync();  // the chunks of fill_input that hold IDE columns are written
            for (int t = 0; t < NT; ++t)
              ide_fill_staged(Tile{inb(t)}, p.dir, xst(t), xst(t) + 3 * kRows, xst(t) + 6 * kRows,
                              p.d0, rows[t]);
          }
        }
      }
      publish();
      PHASE_MARK(0, kScal);

      // 2. The layers: h_l = relu(cdt(cdt(acc) + b_l)) on bf16 pairs to the
      // activation tiles (the last one, y, only for the bottleneck head) and
      // kept in acc; with the density gradient the relu' bits in the
      // accumulators' order.
      for (int l = 0; l < p.depth; ++l) {
        if (l == 0)
          product_n<NT>(acc, inb_s, kp / 64, inb_s, p.kin, ring_st);
        else
          product_n<NT>(acc, act_s, kW / 64, inb_s, k_dim(p, l), ring_st);
        PHASE_MARK(1, kProd);
        cons_sync();  // both warpgroups' products have read the tiles
        const bool keep = l + 1 < p.depth || HC > 0;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          uint32_t mk[2] = {0u, 0u};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = fc + 8 * j;
            const __nv_bfloat162 bb =
                *reinterpret_cast<const __nv_bfloat162*>(bias + l * kW + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h;
              // cdt(acc) + cdt(b) in one rounding (the exact sum of two bf16
              // values rounds as their f32 sum does), then ReLU.
              const uint32_t v = bits2(__hmax2(__hadd2(__floats2bfloat162_rn(acc[t][i],
                                                                             acc[t][i + 1]),
                                                       bb),
                                               __float2bfloat162_rn(0.f)));
              mk[i >> 5] |= ((v & 0x7fffu) != 0u ? 1u : 0u) << (i & 31);
              mk[i >> 5] |= ((v & 0x7fff0000u) != 0u ? 1u : 0u) << ((i + 1) & 31);
              if (keep) put2(t, fr + 8 * h, c, v);
              acc[t][i] = __uint_as_float(v << 16);
              acc[t][i + 1] = __uint_as_float(v & 0xffff0000u);
            }
          }
          if (dg) masks[l * kCons + tid] = make_uint2(mk[0], mk[1]);
        }
        publish();
        PHASE_MARK(1, kScal);
      }
      // K11: y from the registers, where the last epilogue left it (bf16
      // values, so repacking them is exact): a quad's 4 lanes write 16
      // contiguous bytes of a row a store.
      if constexpr (YO) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gr = row0[t] + fr + 8 * h;
            if (gr >= p.n) continue;
            bf16* yr = static_cast<bf16*>(p.y) + static_cast<size_t>(gr) * kW;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int i = 4 * j + 2 * h;
              *reinterpret_cast<__nv_bfloat162*>(yr + fc + 8 * j) =
                  __floats2bfloat162_rn(acc[t][i], acc[t][i + 1]);
            }
          }
        PHASE_MARK(1, kStore);
      }

      // 3. sigma = f32(y) wd and the f32 heads f32(y) wh^T + bh from the
      // registers; then a thread an output sums the two warpgroups' halves
      // and stores it (K6 keeps sigma), and with K10 a thread a row runs the
      // colour epilogue on the rgb head.
      {
        const int nh = 1 + p.hf;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float* rw = red(t) + wg * kRows * nred;
          if (p.wd != nullptr) head_part(acc[t], wdp, fc, fr, rw, nred, 0);
          for (int k = 0; k < p.hf; ++k)
            head_part(acc[t], whp + k * kW, fc, fr, rw, nred, 1 + k);
        }
        cons_sync();
        for (int t = 0; t < NT; ++t) {
          float* rd = red(t);
          for (int i = tid; i < rows[t] * nh; i += kCons) {
            const int r = i / nh, k = i - r * nh;
            const size_t gr = static_cast<size_t>(row0[t] + r);
            const float s = rd[r * nred + k] + rd[(kRows + r) * nred + k];
            if (k == 0) {
              if (p.wd != nullptr) {
                p.sig[gr] = s;
                if constexpr (SPA) {
                  if (p.wts != nullptr) sraw[(tp + t) * kRows + r] = s;
                }
              }
            } else {
              const float v = s + p.bh[k - 1];
              p.hout[gr * p.hf + k - 1] = v;
              rd[r * nred + k] = v;
            }
          }
        }
        if constexpr (DIR) {
          if (p.rgb != nullptr) {  // K10 on the rgb head just summed
            cons_sync();
            for (int t = 0; t < NT; ++t)
              if (tid < rows[t]) {
                const size_t o = static_cast<size_t>(row0[t] + tid) * 3;
                float out[3], unused[3];
                rgb_epilogue(red(t) + tid * nred + 1, p.rgbe.rawd + o, p.rgbe.rawt + o, p.rgbe,
                             out, nullptr, unused, unused, unused);
#pragma unroll
                for (int c = 0; c < 3; ++c) p.rgb[o + c] = out[c];
              }
          }
        }
        PHASE_MARK(2, kScal);
      }

      // 4. The bottleneck head hc = cdt(y wc^T) + cdt(bc), from its
      // accumulators to device memory.
      if constexpr (HC > 0) {
        product_n<NT>(acc, act_s, kW / 64, act_s, kW, ring_st);
        PHASE_MARK(2, kProd);
        if (128 * wg < HC) {
          const bf16* bc = static_cast<const bf16*>(p.bc);
          bf16* out = static_cast<bf16*>(p.cout);
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int c = fc + 8 * j;
              if (c >= HC) continue;
              const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bc + c);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int gr = row0[t] + fr + 8 * h, i = 4 * j + 2 * h;
                if (gr < p.n)
                  *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(gr) * HC + c) =
                      __floats2bfloat162_rn(bias_add<bf16>(acc[t][i], bb.x),
                                            bias_add<bf16>(acc[t][i + 1], bb.y));
              }
            }
        }
        PHASE_MARK(2, kStore);
      }

      // 5. K3 (one tile at a time): the chain s_{L-1} = relu'(h) cdt(wd),
      // s_{l-1} = relu'(h_{l-1}) cdt(s_l Wa_l), with u_x = s_skip Wx_skip +
      // s_0 Wx_0 in f32 in its own accumulators; then the fold u = (f32(xc)
      // u_xs - f32(xs) u_xc) S.
      if constexpr (NT == 1) {
        if (dg)
          chain<SPA>(p, acc, act0, inb0, masks, xst0, ut, row0[0], rows[0], ring_st PHASE_ARG);
      }
    }

    // K6: the weights of the unit's rays, one warp a ray.
    if constexpr (SPA) {
      if (p.wts != nullptr) {
        cons_sync();
        const int base = unit * tiles * kRows, S = p.samples;
        const float bsig = __ldg(p.bsig);
        for (int q = warp; q < tiles * kRows / S; q += kCons / 32) {
          const int r0 = base + q * S;
          if (r0 >= p.n) break;
          ray_weights(sraw + q * S, p.delta + r0, bsig, S, p.wts + r0, nullptr, nullptr);
        }
        PHASE_MARK(4, kScal);
      }
    }
  }
}

// Shared memory of a launch of NT tiles at a time through a ring of
// `stages` slices, without the f32 heads' weights (`heads`).
size_t fwd_smem(const FwdParams& p, int nt, int stages, int tiles, bool in_act, size_t& heads) {
  const int kp = (p.kin + kBK - 1) / kBK * kBK;
  const int nred = 1 + p.hf > 4 ? 1 + p.hf : 4;
  heads = 4 * static_cast<size_t>(1 + p.hf) * kW;
  return 1024 + static_cast<size_t>(stages) * kSlice + nt * (kW / 64 + kp / 64) * kBlk +
         (nt == 1 && p.u != nullptr ? 8 * static_cast<size_t>(p.depth) * kCons : 0) +
         (nt == 1 && p.u != nullptr ? 4 * static_cast<size_t>(kRows) * p.kin : 0) +
         (in_act ? 0 : 4 * static_cast<size_t>(nt) * (kXst + 2 * kRows * nred)) +
         (p.wts != nullptr ? 4 * static_cast<size_t>(tiles) * kRows : 0) + 8 + 16 * stages;
}

// A launch that runs NT tiles at a time, units of `tiles` tiles: the
// deepest ring (kStages down to 2) that fits, then the heads' weights if
// they fit too. YO: with K11's y.
template <int HC, bool DIR, bool SPA, int NT, bool YO = false>
int launch_fwd_tma(const FwdParams& p, int tiles, cudaStream_t stream) {
  FwdMaps m;
  memset(&m, 0, sizeof(m));
  const bf16* w = static_cast<const bf16*>(p.w);
  const bf16* wt = static_cast<const bf16*>(p.wt);
  size_t off = 0;
  bool ok = true;
  for (int l = 0; l < p.depth; ++l) {
    const int K = l == 0 ? p.kin : (l == p.skip ? kW + p.kin : kW);
    ok = ok && make_map(&m.w[l], w + off, K, kW, K, kW);
    if (p.u != nullptr) ok = ok && make_map(&m.wt[l], wt + off, kW, K, kW, kW);
    off += static_cast<size_t>(kW) * K;
  }
  if (HC > 0) ok = ok && make_map(&m.wc, p.wc, kW, HC, kW, kW);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // xst and red in the activation tiles: without the bottleneck head, and
  // where the staged segments leave room for xst.
  const int nred = 1 + p.hf > 4 ? 1 + p.hf : 4;
  const int tile_bytes = (kW / 64) * kBlk;
  const bool in_act = HC == 0 && NT == 2 &&
                      2 * kRows * (p.d0 + p.d1) + 4 * kXst <= tile_bytes &&
                      4 * 2 * kRows * nred + 4 * kXst <= tile_bytes;
  size_t heads = 0, smem = 0;
  int stages = kStages;
  for (; stages >= 2; --stages) {
    smem = fwd_smem(p, NT, stages, tiles, in_act, heads);
    if (smem <= 232448) break;
  }
  if (stages < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
  m.stages = stages;
  m.tiles = tiles;
  m.small_in_act = in_act;
  m.heads_in_smem = smem + heads <= 232448;
  if (m.heads_in_smem) smem += heads;
  cudaError_t err = cudaFuncSetAttribute(trunk_fwd_tma_kernel<HC, DIR, SPA, NT, YO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent: a CTA an SM, each walking units of `tiles` tiles (whole
  // rays with K6), so the producer loads the next unit's first weights
  // during this one's last epilogues.
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (p.n + tiles * kRows - 1) / (tiles * kRows);
  const int grid = units < sms ? units : sms;
  trunk_fwd_tma_kernel<HC, DIR, SPA, NT, YO><<<grid, kFwdThreads, smem, stream>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a width-128 launch (`fwd_two_tiles`) through a ring of
// `stages` slices, without the f32 heads' weights (`heads`).
size_t fwd_w128_smem(const FwdParams& p, int stages, size_t& heads) {
  const int kp = (p.kin + kBK - 1) / kBK * kBK;
  heads = 4 * static_cast<size_t>(p.hf) * 128;
  return 1024 + static_cast<size_t>(stages) * kSliceW<128> + 2 * (128 / 64 + kp / 64) * kBlk +
         4 * static_cast<size_t>(kRows) * (p.d0 + p.d1) + 8 + 16 * stages;
}

// The width-128 trunk: units of two tiles, the deepest ring that fits, then
// the heads' weights if they fit too.
int launch_fwd_tma_w128(const FwdParams& p, cudaStream_t stream) {
  constexpr int W = 128;
  FwdMaps m;
  memset(&m, 0, sizeof(m));
  const bf16* w = static_cast<const bf16*>(p.w);
  size_t off = 0;
  bool ok = true;
  for (int l = 0; l < p.depth; ++l) {
    const int K = l == 0 ? p.kin : (l == p.skip ? W + p.kin : W);
    ok = ok && make_map(&m.w[l], w + off, K, W, K, W);
    off += static_cast<size_t>(W) * K;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  size_t heads = 0, smem = 0;
  int stages = kStages;
  for (; stages >= 2; --stages) {
    smem = fwd_w128_smem(p, stages, heads);
    if (smem <= 232448) break;
  }
  if (stages < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
  m.stages = stages;
  m.tiles = 2;
  m.heads_in_smem = smem + heads <= 232448;
  if (m.heads_in_smem) smem += heads;
  auto* kernel = trunk_fwd_tma_kernel<0, false, false, 2, false, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (p.n + 2 * kRows - 1) / (2 * kRows);
  kernel<<<units < sms ? units : sms, kFwdThreads, smem, stream>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a launch of the wide-input instance (`fwd_wide`, NT
// tiles at a time) through a ring of `stages` slices, without the f32
// heads' weights (`heads`): NT activation tiles and two buffers of NT
// 128-column chunks; with K3 (NT = 1) the relu' bits, u and a product's u of
// each warpgroup, and the fold padded to rows of a multiple of 8.
// fused_mlp.py `kernel_smem` mirrors this sum.
size_t fwd_wide_smem(const FwdParams& p, int nt, int stages, size_t& heads) {
  heads = 4 * static_cast<size_t>(1 + p.hf) * kW;
  const size_t dg = 8 * static_cast<size_t>(p.depth) * kCons + 4 * 3 * kRows * p.nb +
                    4 * static_cast<size_t>(p.d0) * ((p.nb + 7) & ~7);
  return 1024 + static_cast<size_t>(stages) * kSlice + 2 * nt * (kW / 64) * kBlk +
         (nt == 1 ? dg : 0) + 8 + 16 * stages;
}

// The wide-input instance: persistent CTAs of NT tiles (two, or one with
// K3), the deepest ring that fits, then the heads' weights if they fit too.
template <int HC, int NT>
int launch_fwd_tma_wide(const FwdParams& p, cudaStream_t stream) {
  FwdMaps m;
  memset(&m, 0, sizeof(m));
  const bf16* w = static_cast<const bf16*>(p.w);
  const bf16* wt = static_cast<const bf16*>(p.wt);
  size_t off = 0;
  bool ok = true;
  for (int l = 0; l < p.depth; ++l) {
    const int K = l == 0 ? p.kin : (l == p.skip ? kW + p.kin : kW);
    ok = ok && make_map(&m.w[l], w + off, K, kW, K, kW);
    if (NT == 1) ok = ok && make_map(&m.wt[l], wt + off, kW, K, kW, kW);
    off += static_cast<size_t>(kW) * K;
  }
  if (HC > 0) ok = ok && make_map(&m.wc, p.wc, kW, HC, kW, kW);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  size_t heads = 0, smem = 0;
  int stages = kStages;
  for (; stages >= 2; --stages) {
    smem = fwd_wide_smem(p, NT, stages, heads);
    if (smem <= 232448) break;
  }
  if (stages < 2) return static_cast<int>(cudaErrorInvalidConfiguration);
  m.stages = stages;
  m.tiles = NT;
  m.heads_in_smem = smem + heads <= 232448;
  if (m.heads_in_smem) smem += heads;
  auto* kernel = trunk_fwd_tma_kernel<HC, false, false, NT, false, kW, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (p.n + NT * kRows - 1) / (NT * kRows);
  kernel<<<units < sms ? units : sms, kFwdThreads, smem, stream>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes, with refnerf_trunk_fwd's arguments (trunk_fwd.cu):
// the bf16 trunk (dtype 1) of at most kMaxDepth layers, kW input columns
// and kMaxHeads f32 heads; at width 256 K1/K3 (hc 128 or 0; with K6/K7, hc
// 128), K2 (hc 0; with K8-K10) and K11 (y: hc 0, no K3 or fused stage), at
// width 128 the plain K2 alone (hc 0, no density head, K3, fused stage or
// y); past kW and up to kWideKin input columns the spatial trunk at width
// 256 with sigma, the f32 heads and the compute-dtype head (hc 0, 128 or
// 256), and K3 (two segments of equal even width, 4-byte aligned, nb <=
// kMaxNbWide), no fused stage or y (the wide-input instance). Returns the cudaError_t of the
// launch (0 on success); allocates nothing and does not synchronise.
extern "C" int refnerf_trunk_fwd_tma(REFNERF_FWD_ARGS) {
  FwdParams p;
  const int err = fwd_params(p, REFNERF_FWD_NAMES);
  if (err != 0) return err;
  if (dtype != 1 || (width != kW && width != 128) || depth < 1 || depth > kMaxDepth ||
      kin > kWideKin || hf > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dir = p.dir.p != 0 || p.rgb != nullptr;
  const bool spa = p.ipe.lm != nullptr || p.wts != nullptr;
  if (kin > kW) {
    if (width != kW || dir || spa || y != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // K3 reads the segments' values in pairs: d0 even, the bases 4-byte aligned.
    if (u != nullptr &&
        ((d0 & 1) || ((reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(x1)) & 3)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (u != nullptr)
      return hc == 0     ? launch_fwd_tma_wide<0, 1>(p, s)
             : hc == 128 ? launch_fwd_tma_wide<128, 1>(p, s)
             : hc == 256 ? launch_fwd_tma_wide<256, 1>(p, s)
                         : static_cast<int>(cudaErrorInvalidValue);
    return hc == 0     ? launch_fwd_tma_wide<0, 2>(p, s)
           : hc == 128 ? launch_fwd_tma_wide<128, 2>(p, s)
           : hc == 256 ? launch_fwd_tma_wide<256, 2>(p, s)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 128)
    return hc == 0 && !dir && !spa && u == nullptr && wd == nullptr && y == nullptr
               ? launch_fwd_tma_w128(p, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (y != nullptr)
    return hc == 0 && !dir && !spa && u == nullptr
               ? launch_fwd_tma<0, false, false, 2, true>(p, 2, s)
               : static_cast<int>(cudaErrorInvalidValue);
  // Two tiles at a time but with K3 (one at a time: its chain's state does
  // not fit twice); with K6 a unit of whole rays and an even number of tiles.
  const int t1 = p.wts != nullptr ? p.tiles : 1;
  const int t2 = p.wts != nullptr ? (p.tiles % 2 ? 2 * p.tiles : p.tiles) : 2;
  const bool two = p.u == nullptr && t2 * kRows <= 1024;
  if (hc == 0 && !spa && dir)  // never with K3 or K6
    return two ? launch_fwd_tma<0, true, false, 2>(p, t2, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (hc == 0 && !spa)
    return two ? launch_fwd_tma<0, false, false, 2>(p, t2, s)
               : launch_fwd_tma<0, false, false, 1>(p, t1, s);
  if (hc == 128 && !dir && spa)
    return two ? launch_fwd_tma<128, false, true, 2>(p, t2, s)
               : launch_fwd_tma<128, false, true, 1>(p, t1, s);
  if (hc == 128 && !dir)
    return two ? launch_fwd_tma<128, false, false, 2>(p, t2, s)
               : launch_fwd_tma<128, false, false, 1>(p, t1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 trunk backward for Hopper (sm_90a) at widths 256 and 128: wgmma
// products fed by a TMA weight ring, and a wgmma weight-gradient product.
//
// Replaces, for the compute dtype bfloat16 at width 256, the backward Pallas
// kernel `_bwd_kernel` (:668-853) of refnerf_tpu/ops/pallas/fused_mlp.py in
// the modes of trunk_bwd.cu (K4 with and without u's cotangent, K5 with dx,
// K6/K7 in K4, K8-K10 in K5, K11's y cotangent), and at width 128 in the
// plain K5 (mip-NeRF's directional trunk), up to 8 layers and 256 input
// columns, and K4 with the density head, f32 heads, a 128- or 256-wide
// bottleneck and u's cotangent on up to kWideKin input columns (the
// wide-input instance, `bwd_wide`: mip-NeRF 360's proposal MLP and the JAX
// package's default MLP, 504 IPE columns; trunk_bwd.cu's mma.sync design
// ran the former before), with the same arithmetic and bf16 roundings
// (trunk_bwd.cu:32-40) and the same C arguments. The float32 instances and
// the trunks past these shapes stay in trunk_bwd_f32.cu and trunk_bwd.cu.
//
// Bound on the H100: the per-tile work is ~2.6 GFLOP of bf16 products a
// 64-sample tile for K4 with u's cotangent (3.2 TFLOP at N = 524,288 with
// the weight gradients; 3.2 ms at 989 TFLOP/s); the weight-gradient
// operands (h, zeta, s, p, x, ts, cbar: ~17 KB a sample for K4, ~8.6 KB for
// K5, ~4.5 KB for K5 at width 128) cross device memory twice, written here
// and read once by wgrad_tma_kernel: ~5.3 ms (K4), ~2.7 ms (K5) and ~1.4 ms
// (K5 at width 128, against its 0.5 ms of products) at 3.35 TB/s, the
// floor of this data flow, above the products' bound. (That kernel's 128 x
// 128 output tiles read Z and A twice for a 256-row gradient; the tiles of
// one split of samples are adjacent in its grid, so the second read comes
// from L2.) A 64-row tile reads each layer's weights (128 KB) from L2 for
// 8.4 MFLOP, 64 FLOP a byte; at width 128 a tile's products are a quarter
// as large, so a CTA holds two tiles that share each weight slice.
//
// Design.
//  - Two consumer warpgroups and one producer warp a CTA of 64 samples.
//    Each product acc[64][256] = A[64][K] B[256][K]^T runs as
//    wgmma m64n128k16, warpgroup g owning output columns [128 g, 128 g +
//    128): 64 f32 accumulators a thread, in the wgmma layout (acc[4 j + 2 h
//    + e] at row 16 w + lane / 4 + 8 h, column 128 g + 8 j + 2 (lane % 4) +
//    e, w the warp of the warpgroup). At width 128 a CTA holds two tiles
//    of 64 samples, warpgroup g owning all 128 columns of tile g with the
//    same accumulators and epilogues, and both read each [128][64] weight
//    slice (16 KB): twice the products a byte of weights. There zeta_skip
//    waits in the tile's input blocks (free after the recompute), and dx is
//    one product at l = 0, [zeta_skip | zeta_0] against [Wx_skip ; Wx_0],
//    in passes of 128 input columns: no f32 scratch for the skip share.
//  - A (the activation tile, the input tile) lives in shared memory in
//    wgmma's K-major 128-byte-swizzled layout: 64-column blocks of 64 rows x
//    128 bytes, 16-byte chunk q of row r at chunk q ^ (r % 8). Every access
//    goes through `sw_off`.
//  - B, the weights, come by TMA (cp.async.bulk.tensor) from the forward
//    pack `w` and the transposed pack `wt` (one tensor map a layer, its K
//    extent exact: slices past it read zeros) and `wct`, in 64-deep K-slices
//    of 256 rows (32 KB), through a ring of kStages stages with full/empty
//    mbarriers. The producer warp walks the same schedule of products as the
//    consumers (`schedule`), so the next layer's weights arrive while the
//    consumers run an epilogue; no CTA-wide barrier per K-slice.
//  - The scalar passes live in the products' epilogues, in registers: the
//    bias, ReLU and rounding; the relu' masks, 64 bits a thread and layer
//    in the accumulator's own order (no ballot, no lookup by column); the
//    column sums of the bias gradients by shuffles over the 8 lanes of a
//    column and a fixed-order sum over the 4 warps.
//  - The weight-gradient operands leave sample-major ([rows][features],
//    the tile as it sits in shared memory) by TMA stores; wgrad_tma_kernel
//    reads them by TMA as the MN-major (transposed) operands of wgmma, on
//    128 x 128 output tiles per split of samples, and writes each split's
//    partial; reduce_kernel (trunk_bwd.cu) sums the partials in a fixed
//    order. No float atomics: the gradients do not depend on the schedule.
//    At width 128 the bias gradients' column sums add tile 0's four warps,
//    then tile 1's, into one row of partials a CTA.
// One CTA an SM (~200 KB of shared memory; 168 registers a thread, as
// ptxas allots a 288-thread block in whole warpgroups): the ring's four
// stages hold a whole 256-deep layer, so the weights of the next product
// load during the epilogue, while the epilogue itself leaves the tensor
// cores idle. With no other CTA to hide latency, the scalar loops keep
// kBatch loads in flight a thread.

#include <string.h>

#define PHASE_SYNC() cons_sync()  // closes a stamped segment
#include "hopper_tma.cuh"
#include "trunk_bwd_args.cuh"

namespace {

constexpr int kStages = 4;
constexpr int kWideChunk = 128;  // input columns of a chunk of the wide-input instance
// The ring's stages of the wide-input instance: 3 with the cotangent of u,
// whose fold then lies in shared memory.
__host__ __device__ constexpr int wide_stages(bool dg) { return dg ? 3 : kStages; }

struct TmaMaps {
  CUtensorMap w[kMaxDepth];   // layer l of `w`: [W][K_l], box 64 x 256
  CUtensorMap wt[kMaxDepth];  // layer l of `wt`: [K_l][W], box 64 x 256
  CUtensorMap wct;            // [W][HC]
  CUtensorMap hs, zs, ss, ps;  // [depth * rp][W] scratch, box 64 x 64
  CUtensorMap xs, ts;          // [rp][kin]
  CUtensorMap cs;              // [rp][HC]
};

template <int W>
__device__ __forceinline__ int k_dim(const BwdParams& p, int l) {
  return l == 0 ? p.kin : (l == p.skip ? W + p.kin : W);
}

// The products of one CTA in order, as (tensor map, first B row, K); the
// producer loads their slices, and the kernel below runs them in this order.
// At width 128 dx is one product at l = 0, [zeta_skip | zeta_0] against
// [Wx_skip ; Wx_0], over the kin input columns in passes of 128.
template <int HC, int W, typename F>
__device__ void schedule(const BwdParams& p, const TmaMaps& m, F&& load) {
  const bool dg = p.ubar != nullptr, dx = p.dx0 != nullptr;
  for (int l = 0; l < p.depth; ++l) load(&m.w[l], 0, k_dim<W>(p, l));  // recompute
  if (dg)
    for (int l = p.depth - 1; l > 0; --l) load(&m.wt[l], 0, W);  // inner chain
  if (HC > 0) load(&m.wct, 0, HC);                               // head backward
  for (int l = p.depth - 1; l >= 0; --l) {                       // first-order reverse
    if (dx && (l == 0 || l == p.skip)) {
      if constexpr (W == kW) {
        load(&m.wt[l], l == 0 ? 0 : kW, kW);
      } else if (l == 0) {
        for (int cx = 0; cx < p.kin; cx += W) {
          if (p.skip >= 0) load(&m.wt[p.skip], W + cx, W);
          load(&m.wt[0], cx, W);
        }
      }
    }
    if (l > 0) load(&m.wt[l], 0, W);
  }
  if (dg)
    for (int l = 0; l < p.depth; ++l) load(&m.w[l], 0, k_dim<W>(p, l));  // tangent
}

// Column sums over the CTA's rows of the values each thread holds for its
// two rows, cs[j][e] for column 128 g + 8 j + 2 (lane % 4) + e of warpgroup
// g's columns (at width 128 column 8 j + 2 (lane % 4) + e of tile g):
// shuffles over the 8 lanes of a column, then the 4 warps in order through
// `red` (at width 128 tile 0's, then tile 1's). out[c] = (add ? out[c] : 0)
// + sum for c < ncols. All consumers call it.
template <int W>
__device__ void col_sums(float (&cs)[16][2], float* red, float* out, int ncols, bool add) {
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, w4 = (tid >> 5) & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[w4 * kCons + 128 * wg + 8 * j + 2 * lane + e] = v;
    }
  cons_sync();
  if (tid < ncols) {
    float s = ((red[tid] + red[kCons + tid]) + red[2 * kCons + tid]) + red[3 * kCons + tid];
    if constexpr (W != kW) {
      const int c = W + tid;  // tile 1's sum of the column
      s = s + (((red[c] + red[kCons + c]) + red[2 * kCons + c]) + red[3 * kCons + c]);
    }
    out[tid] = add ? out[tid] + s : s;
  }
  cons_sync();
}


// Loads a thread keeps in flight in the scalar loops over a tile: with one
// CTA an SM no other warps hide their latency, so a loop that waits for
// each load in turn costs a round trip an element.
constexpr int kBatch = 8;

// The trunk input tile (trunk_common.cuh `load_input`) in the swizzled
// layout, zero-padded to kp columns.
template <bool DIR>
__device__ void load_input_sw(const Tile& t, const bf16* x0, int d0, const bf16* x1, int d1, int kp,
                              int row0, int n, const DirIn& dir) {
  const int dide = DIR ? dir.width() : 0, total = kRows * kp;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kCons) {
    bf16 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons, r = i / kp, c = i % kp, gr = row0 + r, c1 = c - d0 - dide;
      v[u] = from_f<bf16>(0.f);
      if (i < total && gr < n) {
        if (c < d0)
          v[u] = __ldg(x0 + static_cast<size_t>(gr) * d0 + c);
        else if (c1 >= 0 && c1 < d1)
          v[u] = __ldg(x1 + static_cast<size_t>(gr) * d1 + c1);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons, r = i / kp, c = i % kp;
      if (i < total && !(DIR && c >= d0 && c - d0 - dide < 0)) t(r, c) = v[u];
    }
  }
  if constexpr (DIR) {
    if (dir.p) {  // the IDE block (trunk_common.cuh `ide_fill`)
      const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
      const DirSample s = load_dir(dir, row0 + r, n);
      for (int i = q; i < dir.p; i += 4) {
        const Harm h = ide_harmonic(dir, s.rd[0], s.rd[1], s.rd[2], i);
        const float zpat = h.zp * expf(mul(-s.ki, __ldg(dir.sg + i)));
        t(r, d0 + i) = from_f<bf16>(s.live ? h.re * zpat : 0.f);
        t(r, d0 + dir.p + i) = from_f<bf16>(s.live ? h.im * zpat : 0.f);
      }
      if (dir.geo && q == 0) t(r, d0 + 2 * dir.p) = from_f<bf16>(s.live ? s.nd : 0.f);
    }
  }
}

// K7's input tile (trunk_common.cuh `load_ipe`) in the swizzled layout.
__device__ void load_ipe_sw(const Tile& t, const Ipe& q, int F, int kp, int row0, int n) {
  for (int i = threadIdx.x; i < kRows * kp; i += kCons) {
    const int r = i / kp, c = i % kp, gr = row0 + r;
    if (gr < n && c < F) {
      float e, sn, cs;
      ipe_trig(q, gr, c, e, sn, cs);
      t(r, c) = from_f<bf16>(mul(e, sn));
      t(r, F + c) = from_f<bf16>(mul(e, cs));
    } else if (gr >= n || c >= 2 * F) {
      t(r, c) = from_f<bf16>(0.f);
    }
  }
}

// Width 128: the CTA's two 64-row input tiles (tile g at inb + g * in_b)
// in the swizzled layout (load_input_sw without the IDE block),
// zero-padded to kp columns and past row n; x0 in 16-byte loads, one
// swizzled chunk of 8 columns each, where its rows allow (d0 a multiple of
// 8, the pointer 16-byte aligned). Thread t keeps to row t % 128, and every
// load of a batch is in flight before its stores.
__device__ void load_input_rows(unsigned char* inb, int in_b, const bf16* x0, int d0,
                                const bf16* x1, int d1, int kp, int row0, int n) {
  constexpr int R = 2 * kRows;
  const auto at = [&](int r, int c) { return inb + (r / kRows) * in_b + sw_off(r % kRows, c); };
  int c_lo = 0;  // columns [0, c_lo) come by the 16-byte loads
  if ((d0 & 7) == 0 && (reinterpret_cast<uintptr_t>(x0) & 15) == 0) {
    const int total = R * (d0 / 8);
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kCons) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kCons, gr = row0 + i % R;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && gr < n)
          v[u] = __ldg(reinterpret_cast<const uint4*>(x0 + static_cast<size_t>(gr) * d0) + i / R);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kCons;
        if (i < total) *reinterpret_cast<uint4*>(at(i % R, 8 * (i / R))) = v[u];
      }
    }
    c_lo = d0;
  }
  const int total = R * (kp - c_lo);
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kCons) {
    bf16 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons, gr = row0 + i % R, c = c_lo + i / R, c1 = c - d0;
      v[u] = from_f<bf16>(0.f);
      if (i < total && gr < n) {
        if (c < d0)
          v[u] = __ldg(x0 + static_cast<size_t>(gr) * d0 + c);
        else if (c1 < d1)
          v[u] = __ldg(x1 + static_cast<size_t>(gr) * d1 + c1);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons;
      if (i < total) *reinterpret_cast<bf16*>(at(i % R, c_lo + i / R)) = v[u];
    }
  }
}

// DG on the wide-input instance: columns [c0, c0 + cw) (cw a multiple of 8)
// of the tangent of the trunk input, ts = (cdt(tp xc), cdt(-(tp xs))) with
// tp = ubar S^T (f32, summed over the basis in order; ub the tile's rows of
// ubar [kRows][nb], fs the fold S [d0][nb], both in shared memory), to
// `buf`, a [64][.] tile of 64-column swizzled blocks, 16 bytes a store; the
// partner segment's value (xc for a sin column c, xs for a cos column d0 +
// c) read from device memory, a column pair a load (d0 even), all of a
// thread's in flight at once (cw at most kWideChunk). A warp's lanes take
// 32 rows of one 8-column group: their reads of S are one address, those
// of ubar 32 banks, and a lane's 8 sums are independent. Zeros past the
// segments and past `rows`.
__device__ void ts_chunk(unsigned char* buf, const BwdParams& p, const float* ub, const float* fs,
                         int c0, int cw, int row0, int rows) {
  constexpr int kIt = kRows * (kWideChunk / 8) / kCons;  // a thread's groups of a full chunk
  const int F = p.d0, nb = p.nb, q8 = cw / 8;
  const bf16* x0 = static_cast<const bf16*>(p.x0);
  const bf16* x1 = static_cast<const bf16*>(p.x1);
  // Every partner value of the thread's groups in flight before any is used.
  uint32_t xv[kIt][4];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = threadIdx.x + it * kCons, r = i % kRows, c = 8 * (i / kRows);
    const size_t o = static_cast<size_t>(row0 + r) * F;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      // Columns k and k + 1 (k even) lie in one segment, d0 being even.
      const int k = c0 + c + e;
      xv[it][e >> 1] = 0u;
      if (i < kRows * q8 && r < rows && k < 2 * F)
        xv[it][e >> 1] =
            *reinterpret_cast<const uint32_t*>(k < F ? x1 + o + k : x0 + o + (k - F));
    }
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = threadIdx.x + it * kCons, r = i % kRows, c = 8 * (i / kRows);
    if (i >= kRows * q8) continue;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (r < rows) {
      const float* fr[8];  // each column's row of S (past the segments any row)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = c0 + c + e;
        fr[e] = fs + (k < F ? k : min(k - F, F - 1)) * nb;
      }
      float tp[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < nb; ++j) {
        const float u = ub[r * nb + j];
#pragma unroll
        for (int e = 0; e < 8; ++e) tp[e] = fmaf(u, fr[e][j], tp[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int k = c0 + c + e;
        if (k >= 2 * F) continue;
        // bf16 to f32: the bits in the upper half.
        const float y0 = __uint_as_float(xv[it][e >> 1] << 16);
        const float y1 = __uint_as_float(xv[it][e >> 1] & 0xffff0000u);
        const __nv_bfloat162 t = k < F ? __floats2bfloat162_rn(tp[e] * y0, tp[e + 1] * y1)
                                       : __floats2bfloat162_rn(-(tp[e] * y0), -(tp[e + 1] * y1));
        w[e >> 1] = *reinterpret_cast<const uint32_t*>(&t);
      }
    }
    *reinterpret_cast<uint4*>(buf + sw_off(r, c)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------------------
// The wide-input instance (WIDE): the backward of the spatial trunk at
// width 256 on more than kW and at most kWideKin input columns, with the
// density head and f32 heads (the bottleneck's and u's cotangents: HC and
// DG below; no fused stage, y or dx): mip-NeRF 360's proposal MLP, 504 IPE
// columns (kin 512 packed). The body below keeps the whole input tile,
// which at 512 columns does not fit beside the 4-stage ring. Here the
// recompute streams layer 0's input, and the skip layer's input share,
// through slots of kWideChunk columns, as trunk_fwd_tma.cu `fwd_wide`
// does: two buffers in the input tile's place (the 32 KB of a 256-column
// instance) and, at layer 0, the activation tile's halves (free until its
// epilogue). A chunk's cp.asyncs land while the chunks before it run their
// products, which sum into the accumulators (`product` with `acc_in`): at
// layer 0 the first four chunks (all 512 columns) are in flight from the
// start, at the skip layer the next one. At layer 0 each chunk's blocks
// also leave by TMA to the x scratch, from which wgrad_tma_kernel makes the
// wide gradients on more 128-column output tiles (the same fixed-order
// reduction after). The rest is the body's steps 1,
// 2, 3, 5 and 6 for these modes, with their arithmetic and roundings; the
// last activation y does not go to the scratch (no weight gradient reads
// it). The producer walks the same `schedule`.
//
// HC: the compute-dtype head's cotangent (128 or 256 wide: the MLP's
// bottleneck), as the body's step 5; y then goes to the scratch for dwc. DG:
// the cotangent of u, as the body's steps 4 and 7: the inner chain's s_l to
// the scratch, then the tangent chain, whose input ts = (cdt(tp xc),
// cdt(-(tp xs))), tp = ubar S^T, is made chunk by chunk in the chunks'
// slots (`ts_chunk`, the partner segment's values read from device memory;
// at layer 0 each chunk also leaves to the ts scratch) and made again at the
// skip layer.
template <int HC, bool DG>
__device__ __forceinline__ void bwd_wide(const BwdParams& p, const TmaMaps& m,
                                         unsigned char* smem) {
  constexpr int W = kW, ChB = (kWideChunk / 64) * kBlk;  // a chunk's bytes
  constexpr int NS = wide_stages(DG);
  const int kp = (p.kin + kBK - 1) / kBK * kBK, nc = (kp + kWideChunk - 1) / kWideChunk;
  unsigned char* ring = smem;                       // NS x [256][64]
  unsigned char* act = ring + NS * kSlice;          // [64][256]: h, then zeta
  unsigned char* inb = act + (W / 64) * kBlk;       // 2 x [64][kWideChunk]: input chunks
  uint2* masks = reinterpret_cast<uint2*>(inb + 2 * ChB);          // [depth][256]
  float* red = reinterpret_cast<float*>(masks + p.depth * kCons);  // [4][256]
  float* sb = red + 4 * kCons;                                     // [kRows]
  float* hb = sb + kRows;                                          // [kRows][hf]
  float* ub = hb + kRows * p.hf;                                   // DG: [kRows][nb]
  float* fs = ub + (DG ? kRows * p.nb : 0);                        // DG: the fold [d0][nb]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(fs + (DG ? p.d0 * p.nb : 0)) + 7) &
      ~static_cast<uintptr_t>(7));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ring_st{smem_u32(ring), smem_u32(bars), smem_u32(bars + NS), NS, 0, 0u};

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(ring_st.full + 8 * s, 1);
      mbar_init(ring_st.empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons / 32) {  // the producer warp: weight slices, in order
    if (lane == 0) {
      schedule<HC, W>(p, m, [&](const CUtensorMap* map, int row, int K) {
        for (int k = 0; k < K; k += kBK) {
          mbar_wait(ring_st.empty + 8 * ring_st.stage, ring_st.phase ^ 1u);
          mbar_expect_tx(ring_st.full + 8 * ring_st.stage, kSlice);
          tma_load(ring_st.base + ring_st.stage * kSlice, map, ring_st.full + 8 * ring_st.stage,
                   k, row);
          ring_st.advance();
        }
      });
    }
    return;
  }

  // The consumers.
  PHASE_START;
  const int wg = tid >> 7, w4 = warp & 3;
  const int fr = 16 * w4 + (lane >> 2);      // acc[4 j + 2 h + e]: row fr + 8 h,
  const int fc = 128 * wg + 2 * (lane & 3);  // column fc + 8 j + e
  const int row0 = blockIdx.x * kRows, rows = max(0, min(kRows, p.n - row0));
  const int rp = p.rp;
  const Tile A{act};
  const uint32_t act_s = smem_u32(act);
  const bf16* bias = static_cast<const bf16*>(p.b);
  float* vec = p.vec + static_cast<size_t>(blockIdx.x) * p.nvec;
  const int o_dwd = p.depth * W;
  const int o_dwh = o_dwd + (p.wd != nullptr ? W : 0);
  const int o_dbh = o_dwh + p.hf * W;
  [[maybe_unused]] const int o_dbc = o_dbh + p.hf;
  float acc[64];

  // Before a tile or buffer is overwritten: the TMA stores have read it,
  // and every consumer is done with it.
  auto settle = [&]() {
    if (tid == 0) bulk_wait_read();
    cons_sync();
  };
  // After the consumers wrote a tile: visible to TMA and wgmma.
  auto publish = [&]() {
    fence_async_smem();
    cons_sync();
  };
  // The activation tile to rows [row, row + 64) of a [rows][256] scratch map.
  auto store_act = [&](const CUtensorMap* map, int row) {
    if (tid == 0) {
      for (int b = 0; b < W / 64; ++b) tma_store(map, act_s + b * kBlk, 64 * b, row);
      bulk_commit();
    }
  };
  auto put2 = [&](int r, int c, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(act + sw_off(r, c)) = __floats2bfloat162_rn(a, b);
  };
  // Slot k of a chunk: the two buffers, then the activation tile's halves.
  auto slot = [&](int k) { return k < 2 ? inb + k * ChB : act + (k - 2) * ChB; };
  // Chunk c of the tile's input in flight to slot k (one cp.async group a
  // thread).
  auto issue = [&](int c, int k) {
    wide_chunk<kWideChunk>(slot(k), static_cast<const bf16*>(p.x0), p.d0,
                           static_cast<const bf16*>(p.x1), p.d1, c * kWideChunk,
                           min(kWideChunk, kp - c * kWideChunk), row0, rows, tid, kCons);
    cp_async_commit();
  };
  // acc (+)= layer l's input share, chunk by chunk through S slots (chunk c
  // in slot c % S, the next S - 1 in flight during its products); chunks
  // [0, issued) are in flight at entry. At layer 0 each chunk also leaves to
  // the x scratch. Before a slot is refilled, its last chunk's products and
  // store have read it.
  auto input_share = [&](int l, int S, int issued) {
    for (int c = 0; c < nc; ++c) {
      if (issued < min(nc, c + S)) {
        settle();
        for (; issued < min(nc, c + S); ++issued) issue(issued, issued % S);
      }
      cp_async_wait_upto(issued - 1 - c);
      publish();
      PHASE_MARK(0, kScal);
      const uint32_t a = smem_u32(slot(c % S));
      if (l == 0 && tid == 0) {
        for (int k = 0; k < kWideChunk / 64 && c * kWideChunk + 64 * k < kp; ++k)
          tma_store(&m.xs, a + k * kBlk, c * kWideChunk + 64 * k, row0);
        bulk_commit();
      }
      product<W>(acc, a, kWideChunk / 64, a, min(kWideChunk, p.kin - c * kWideChunk), ring_st,
                 l | c);
      PHASE_MARK(1, kProd);
    }
  };

  // 1. The first four chunks in flight; the cotangents.
  const int first = min(nc, 4);
  for (int c = 0; c < first; ++c) issue(c, c);
  for (int r = tid; r < kRows; r += kCons)
    sb[r] = (p.sbar != nullptr && r < rows) ? p.sbar[row0 + r] : 0.f;
  for (int i = tid; i < kRows * p.hf; i += kCons)
    hb[i] = (p.hbar != nullptr && i / p.hf < rows)
                ? p.hbar[static_cast<size_t>(row0) * p.hf + i] : 0.f;
  if constexpr (DG) {
    for (int i = tid; i < kRows * p.nb; i += kCons)
      ub[i] = i / p.nb < rows ? p.ubar[static_cast<size_t>(row0) * p.nb + i] : 0.f;
    for (int i = tid; i < p.d0 * p.nb; i += kCons) fs[i] = __ldg(p.fold + i);
  }
  PHASE_MARK(0, kScal);

  // 2. Recompute: h_l = relu(cdt(acc) + cdt(b_l)) to the scratch (but y
  // without the compute-dtype head),
  // relu' masks as bits in the accumulators' order.
  for (int l = 0; l < p.depth; ++l) {
    if (l == 0 || l == p.skip) {
      if (l > 0) product<W>(acc, act_s, W / 64, act_s, W, ring_st);  // [h | x]: h first
      input_share(l, l > 0 ? 2 : 4, l > 0 ? 1 : first);
      if (l == 0 && p.skip > 0 && p.skip < p.depth) {  // the skip layer's first chunk
        settle();
        issue(0, 0);
      }
    } else {
      product<W>(acc, act_s, W / 64, act_s, W, ring_st);
      PHASE_MARK(1, kProd);
    }
    settle();
    uint32_t mk[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = fc + 8 * j;
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + l * W + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        const float v0 = fmaxf(bias_add<bf16>(acc[i], bb.x), 0.f);
        const float v1 = fmaxf(bias_add<bf16>(acc[i + 1], bb.y), 0.f);
        mk[i >> 5] |= (v0 > 0.f ? 1u : 0u) << (i & 31);
        mk[i >> 5] |= (v1 > 0.f ? 1u : 0u) << ((i + 1) & 31);
        put2(fr + 8 * h, c, v0, v1);
      }
    }
    masks[l * kCons + tid] = make_uint2(mk[0], mk[1]);
    publish();
    PHASE_MARK(1, kScal);
    if (l + 1 < p.depth || HC > 0) store_act(&m.hs, l * rp + row0);
    PHASE_MARK(1, kStore);
  }

  // 3. The head gradients that read y: dwd, dwh, dbh.
  {
    const int c = tid;
    if (p.wd != nullptr) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(sb[r], to_f(A(r, c)), s);
      vec[o_dwd + c] = s;
    }
    for (int j = 0; j < p.hf; ++j) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(hb[r * p.hf + j], to_f(A(r, c)), s);
      vec[o_dwh + j * kW + c] = s;
    }
    if (c < p.hf) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += hb[r * p.hf + c];
      vec[o_dbh + c] = s;
    }
  }
  PHASE_MARK(2, kScal);

  // 4. DG: the inner chain, as the body's step 4: s_{L-1} = relu'(h)
  // cdt(wd), s_{l-1} = relu'(h_{l-1}) cdt(s_l Wa_l), each to the scratch.
  if constexpr (DG) {
    settle();
    {
      const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = fc + 8 * j;
        const float q0 = round_t<bf16>(p.wd[c]), q1 = round_t<bf16>(p.wd[c + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          put2(fr + 8 * h, c, bit_at(mk, i) ? q0 : 0.f, bit_at(mk, i + 1) ? q1 : 0.f);
        }
      }
    }
    publish();
    store_act(&m.ss, (p.depth - 1) * rp + row0);
    PHASE_MARK(3, kScal);
    for (int l = p.depth - 1; l > 0; --l) {
      product<W>(acc, act_s, W / 64, act_s, W, ring_st);
      PHASE_MARK(3, kProd);
      settle();
      const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          put2(fr + 8 * h, fc + 8 * j, bit_at(mk, i) ? round_t<bf16>(acc[i]) : 0.f,
               bit_at(mk, i + 1) ? round_t<bf16>(acc[i + 1]) : 0.f);
        }
      publish();
      store_act(&m.ss, (l - 1) * rp + row0);
      PHASE_MARK(3, kScal);
    }
  }

  // 5. The head backward: g = cdt(g32), g32 = sbar wd + hbar wh^T (head by
  // head, in trunk_bwd.cu's order); with the compute-dtype head g =
  // cdt(cdt(cbar wc^T) + cdt(g32)). zeta_{L-1} = relu'(h) g, and db_{L-1}
  // its column sums.
  float cs[16][2];
  {
    float g3[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) g3[i] = 0.f;
    for (int j = 0; j < p.hf; ++j) {
      const float h0 = hb[fr * p.hf + j], h1 = hb[(fr + 8) * p.hf + j];
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float wv = __ldg(p.wh + j * W + fc + 8 * q + e);
          g3[4 * q + e] = fmaf(h0, wv, g3[4 * q + e]);
          g3[4 * q + 2 + e] = fmaf(h1, wv, g3[4 * q + 2 + e]);
        }
    }
    if (p.wd != nullptr) {
      const float s0 = sb[fr], s1 = sb[fr + 8];
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float wv = __ldg(p.wd + fc + 8 * q + e);
          g3[4 * q + e] = s0 * wv + g3[4 * q + e];
          g3[4 * q + 2 + e] = s1 * wv + g3[4 * q + 2 + e];
        }
    }
    settle();  // every consumer has read y (and the inner chain's last s)
    if constexpr (HC > 0) {
      // cbar to the activation tile, the scratch and dbc; acc = cbar wc^T.
      const bf16* cbar = static_cast<const bf16*>(p.cbar);
      for (int i = tid; i < kRows * (HC / 8); i += kCons) {  // 16-byte chunks
        const int r = i / (HC / 8), q = i % (HC / 8);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (cbar != nullptr && r < rows)
          v = *reinterpret_cast<const uint4*>(cbar + static_cast<size_t>(row0 + r) * HC + 8 * q);
        *reinterpret_cast<uint4*>(act + sw_off(r, 8 * q)) = v;
      }
      publish();
      PHASE_MARK(4, kScal);
      if (tid == 0) {
        for (int b = 0; b < HC / 64; ++b) tma_store(&m.cs, act_s + b * kBlk, 64 * b, row0);
        bulk_commit();
      }
      PHASE_MARK(4, kStore);
      if (tid < HC) {
        float s = 0.f;
        for (int r = 0; r < kRows; ++r) s += to_f(A(r, tid));
        vec[o_dbc + tid] = s;
      }
      product(acc, act_s, HC / 64, act_s, HC, ring_st);
      PHASE_MARK(4, kProd);
      settle();
    }
    const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        float v0, v1;
        if constexpr (HC > 0) {
          v0 = bit_at(mk, i) ? round_t<bf16>(round_t<bf16>(acc[i]) + round_t<bf16>(g3[i])) : 0.f;
          v1 = bit_at(mk, i + 1)
                   ? round_t<bf16>(round_t<bf16>(acc[i + 1]) + round_t<bf16>(g3[i + 1]))
                   : 0.f;
        } else {
          v0 = bit_at(mk, i) ? round_t<bf16>(g3[i]) : 0.f;
          v1 = bit_at(mk, i + 1) ? round_t<bf16>(g3[i + 1]) : 0.f;
        }
        cs[j][0] += v0;
        cs[j][1] += v1;
        put2(fr + 8 * h, fc + 8 * j, v0, v1);
      }
    }
  }
  publish();
  store_act(&m.zs, (p.depth - 1) * rp + row0);
  col_sums<W>(cs, red, vec + (p.depth - 1) * W, W, false);
  PHASE_MARK(4, kScal);

  // 6. The first-order reverse: zeta_{l-1} = relu'(h_{l-1}) cdt(zeta_l
  // Wa_l), db_{l-1}.
  for (int l = p.depth - 1; l > 0; --l) {
    product<W>(acc, act_s, W / 64, act_s, W, ring_st);
    PHASE_MARK(5, kProd);
    settle();
    const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        const float v0 = bit_at(mk, i) ? round_t<bf16>(acc[i]) : 0.f;
        const float v1 = bit_at(mk, i + 1) ? round_t<bf16>(acc[i + 1]) : 0.f;
        cs[j][0] += v0;
        cs[j][1] += v1;
        put2(fr + 8 * h, fc + 8 * j, v0, v1);
      }
    }
    publish();
    store_act(&m.zs, (l - 1) * rp + row0);
    col_sums<W>(cs, red, vec + (l - 1) * W, W, false);
    PHASE_MARK(5, kScal);
  }

  // 7. DG: the tangent chain, as the body's step 7: p_l = relu'(h_l)
  // cdt([p_{l-1} | ts] W_l), to the scratch but the last, whose column sums
  // add to dwd; ts made chunk by chunk in the slots of the recompute's
  // chunks (at layer 0 also to the ts scratch), then again at the skip
  // layer.
  if constexpr (DG) {
    auto ts_share = [&](int l, int S) {
      for (int c = 0; c < nc; ++c) {
        settle();  // the slot's last products and stores have read it
        const int cw = min(kWideChunk, kp - c * kWideChunk);
        ts_chunk(slot(c % S), p, ub, fs, c * kWideChunk, cw, row0, rows);
        publish();
        PHASE_MARK(6, kScal);
        const uint32_t a = smem_u32(slot(c % S));
        if (l == 0 && tid == 0) {
          for (int k = 0; k < cw / 64; ++k)
            tma_store(&m.ts, a + k * kBlk, c * kWideChunk + 64 * k, row0);
          bulk_commit();
        }
        product<W>(acc, a, kWideChunk / 64, a, min(kWideChunk, p.kin - c * kWideChunk), ring_st,
                   (l > 0 ? 1 : 0) | c);
        PHASE_MARK(6, kProd);
      }
    };
    for (int l = 0; l < p.depth; ++l) {
      if (l == 0 || l == p.skip) {
        if (l > 0) product<W>(acc, act_s, W / 64, act_s, W, ring_st);  // [p | ts]: p first
        ts_share(l, l > 0 ? 2 : 4);
      } else {
        product<W>(acc, act_s, W / 64, act_s, W, ring_st);
        PHASE_MARK(6, kProd);
      }
      settle();
      const uint2 mk = masks[l * kCons + tid];
      const bool last = l + 1 == p.depth;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const float v0 = bit_at(mk, i) ? round_t<bf16>(acc[i]) : 0.f;
          const float v1 = bit_at(mk, i + 1) ? round_t<bf16>(acc[i + 1]) : 0.f;
          cs[j][0] += v0;
          cs[j][1] += v1;
          if (!last) put2(fr + 8 * h, fc + 8 * j, v0, v1);
        }
      }
      if (!last) {
        publish();
        store_act(&m.ps, l * rp + row0);
        PHASE_MARK(6, kStore);
      } else {
        col_sums<W>(cs, red, vec + o_dwd, W, true);
        PHASE_MARK(6, kScal);
      }
    }
  }
  if (tid == 0) bulk_wait();
}

// W: the trunk width, 256, or 128 for the plain directional trunk alone (HC
// 0, no fused stage, no K11, no cotangent of u). A CTA holds T = 1 (256) or
// 2 (128) tiles of 64 samples; at 128 warpgroup g runs tile g's products.
// WIDE: the wide-input instance (`bwd_wide`), DG there with the cotangent
// of u.
template <int HC, bool DIR, bool SPA, bool YO, int W = kW, bool WIDE = false, bool DG = false>
__global__ void __launch_bounds__(kTmaThreads, 1)
    trunk_bwd_tma_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ TmaMaps m) {
  static_assert(W == kW || (HC == 0 && !DIR && !SPA && !YO), "width 128: the plain K5 alone");
  static_assert(!WIDE || (W == kW && (HC == 0 || HC == 128 || HC == 256) && !DIR && !SPA && !YO),
                "wide: the heads, the cotangent of u");
  static_assert(WIDE || !DG, "DG: the wide-input instance's");
  constexpr int T = kTiles<W>, R = kRows * T, ActB = (W / 64) * kBlk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if constexpr (WIDE) {
    bwd_wide<HC, DG>(p, m, smem);
    return;
  }
  const int kp = (p.kin + kBK - 1) / kBK * kBK;
  unsigned char* ring = smem;                         // kStages x [W][64]
  unsigned char* act = ring + kStages * kSliceW<W>;   // T x [64][W]: h, s, zeta, p in turn
  unsigned char* inb = act + T * ActB;                // T x [64][kp]: x, then ts
  uint2* masks = reinterpret_cast<uint2*>(inb + (kp / 64) * kBlk * T);  // [depth][256]
  float* red = reinterpret_cast<float*>(masks + p.depth * kCons);  // [4][256]
  float* sb = red + 4 * kCons;                                     // [R]
  float* hb = sb + R;                                              // [R][hf]
  float* ub = hb + R * p.hf;                                       // [R][nb]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(ub + R * p.nb) + 7) & ~static_cast<uintptr_t>(7));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ring_st{smem_u32(ring), smem_u32(bars), smem_u32(bars + kStages), kStages, 0, 0u};

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring_st.full + 8 * s, 1);
      mbar_init(ring_st.empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons / 32) {  // the producer warp: weight slices, in order
    if (lane == 0) {
      schedule<HC, W>(p, m, [&](const CUtensorMap* map, int row, int K) {
        for (int k = 0; k < K; k += kBK) {
          mbar_wait(ring_st.empty + 8 * ring_st.stage, ring_st.phase ^ 1u);
          mbar_expect_tx(ring_st.full + 8 * ring_st.stage, kSliceW<W>);
          tma_load(ring_st.base + ring_st.stage * kSliceW<W>, map,
                   ring_st.full + 8 * ring_st.stage, k, row);
          ring_st.advance();
        }
      });
    }
    return;
  }

  // The consumers.
  PHASE_START;
  const int wg = tid >> 7, w4 = warp & 3;
  const int fr = 16 * w4 + (lane >> 2);                      // acc[4 j + 2 h + e]: row fr + 8 h,
  const int fc = (W == kW ? 128 : 0) * wg + 2 * (lane & 3);  // column fc + 8 j + e
  const int row0 = blockIdx.x * R;
  const int rp = p.rp;
  const bool dg = p.ubar != nullptr;
  // The tile's own activation, input and rows of the cotangents (at width
  // 128 warpgroup g's).
  unsigned char* act_t = act;
  unsigned char* inb_t = inb;
  const float* sbt = sb;
  const float* hbt = hb;
  if constexpr (W != kW) {
    act_t += wg * ActB;
    inb_t += wg * ((kp / 64) * kBlk);
    sbt += kRows * wg;
    hbt += kRows * wg * p.hf;
  }
  const Tile A{act_t}, X{inb_t};
  const uint32_t act_s = smem_u32(act_t), inb_s = smem_u32(inb_t);
  const bf16* bias = static_cast<const bf16*>(p.b);
  float* vec = p.vec + static_cast<size_t>(blockIdx.x) * p.nvec;
  const int o_dwd = p.depth * W;
  const int o_dwh = o_dwd + (p.wd != nullptr ? W : 0);
  const int o_dbh = o_dwh + p.hf * W;
  const int o_dbc = o_dbh + p.hf;
  [[maybe_unused]] const int o_dbsig = o_dbc + HC;
  float acc[64];

  // Before an epilogue overwrites a tile: the TMA stores have read it, and
  // every consumer is done with it.
  auto settle = [&]() {
    if (tid == 0) bulk_wait_read();
    cons_sync();
  };
  // After the consumers wrote a tile: visible to TMA and wgmma.
  auto publish = [&]() {
    fence_async_smem();
    cons_sync();
  };
  // The activation tile's W / 64 blocks to rows [row, row + 64) of a
  // [rows][W] scratch map, and at width 128 tile 1's to the next 64 rows
  // (thread 0's act_s and inb_s are tile 0's).
  auto store_act = [&](const CUtensorMap* map, int row) {
    if (tid == 0) {
      for (int b = 0; b < W / 64; ++b) tma_store(map, act_s + b * kBlk, 64 * b, row);
      if constexpr (T > 1)
        for (int b = 0; b < W / 64; ++b)
          tma_store(map, act_s + ActB + b * kBlk, 64 * b, row + kRows);
      bulk_commit();
    }
  };
  auto store_in = [&](const CUtensorMap* map) {
    if (tid == 0) {
      for (int b = 0; b < kp / 64; ++b) tma_store(map, inb_s + b * kBlk, 64 * b, row0);
      if constexpr (T > 1)
        for (int b = 0; b < kp / 64; ++b)
          tma_store(map, inb_s + (kp / 64 + b) * kBlk, 64 * b, row0 + kRows);
      bulk_commit();
    }
  };
  auto put2 = [&](int r, int c, float a, float b) {
    // The tile's own (act_t), named only at width 128: capturing act_t
    // moved the width-256 instances' code.
    unsigned char* t = act;
    if constexpr (W != kW) t = act_t;
    *reinterpret_cast<__nv_bfloat162*>(t + sw_off(r, c)) = __floats2bfloat162_rn(a, b);
  };

  // 1. The segments (K8 the IDE block, K7 the IPE) and the cotangents.
  if constexpr (SPA) {
    if (p.ipe.lm != nullptr)
      load_ipe_sw(X, p.ipe, p.d0, kp, row0, p.n);
    else
      load_input_sw<false>(X, static_cast<const bf16*>(p.x0), p.d0,
                           static_cast<const bf16*>(p.x1), p.d1, kp, row0, p.n, p.dir);
  } else if constexpr (W == kW) {
    load_input_sw<DIR>(X, static_cast<const bf16*>(p.x0), p.d0, static_cast<const bf16*>(p.x1),
                       p.d1, kp, row0, p.n, p.dir);
  } else {
    load_input_rows(inb, (kp / 64) * kBlk, static_cast<const bf16*>(p.x0), p.d0,
                    static_cast<const bf16*>(p.x1), p.d1, kp, row0, p.n);
  }
  for (int r = tid; r < R; r += kCons)
    sb[r] = (p.sbar != nullptr && row0 + r < p.n) ? p.sbar[row0 + r] : 0.f;
  for (int i = tid; i < R * p.hf; i += kCons)
    hb[i] = (p.hbar != nullptr && row0 + i / p.hf < p.n)
                ? p.hbar[static_cast<size_t>(row0) * p.hf + i] : 0.f;
  if (dg)
    for (int i = tid; i < R * p.nb; i += kCons)
      ub[i] = row0 + i / p.nb < p.n ? p.ubar[static_cast<size_t>(row0) * p.nb + i] : 0.f;
  publish();
  PHASE_MARK(0, kScal);
  store_in(&m.xs);
  PHASE_MARK(0, kStore);

  // 1b. K6: sbar += ct_raw of this tile's rows, and d bsig (trunk_bwd.cu).
  if constexpr (SPA) {
    if (p.wbar != nullptr) {
      const int S = p.samples, hi = min(row0 + kRows, p.n);
      float* ct = reinterpret_cast<float*>(act);  // [kRows]
      float* tr = ct + kRows + warp * S;          // [S] a warp
      for (int r = tid; r < kRows; r += kCons) ct[r] = 0.f;
      cons_sync();
      const float bsig = __ldg(p.bsig);
      for (int q = row0 / S + warp; q * S < hi; q += kCons / 32) {
        const int r0 = q * S;
        ray_weights_vjp(p.sig + r0, p.delta + r0, p.wbar + r0, bsig, S, tr,
                        max(row0, r0) - r0, min(hi, r0 + S) - r0, ct + (r0 - row0));
      }
      cons_sync();
      for (int r = tid; r < kRows; r += kCons) sb[r] = add(sb[r], ct[r]);
      if (tid == 0) {
        float s = 0.f;
        for (int r = 0; r < kRows; ++r) s = add(s, ct[r]);
        vec[o_dbsig] = s;
      }
      cons_sync();
    }
  }
  PHASE_MARK(0, kScal);

  // 2. Recompute: h_l = relu(cdt(acc) + cdt(b_l)) to the scratch, relu'
  // masks as bits in the accumulators' order.
  for (int l = 0; l < p.depth; ++l) {
    if (l == 0)
      product<W>(acc, inb_s, kp / 64, inb_s, p.kin, ring_st);
    else
      product<W>(acc, act_s, W / 64, inb_s, k_dim<W>(p, l), ring_st);
    PHASE_MARK(1, kProd);
    settle();
    uint32_t mk[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = fc + 8 * j;
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + l * W + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        const float v0 = fmaxf(bias_add<bf16>(acc[i], bb.x), 0.f);
        const float v1 = fmaxf(bias_add<bf16>(acc[i + 1], bb.y), 0.f);
        mk[i >> 5] |= (v0 > 0.f ? 1u : 0u) << (i & 31);
        mk[i >> 5] |= (v1 > 0.f ? 1u : 0u) << ((i + 1) & 31);
        put2(fr + 8 * h, c, v0, v1);
      }
    }
    masks[l * kCons + tid] = make_uint2(mk[0], mk[1]);
    publish();
    PHASE_MARK(1, kScal);
    store_act(&m.hs, l * rp + row0);
    PHASE_MARK(1, kStore);
  }

  // 2b. K10: the head recomputed on y, the final rgb's cotangent pulled back
  // through the colour epilogue onto the head's.
  if constexpr (DIR) {
    if (p.rgb_bar != nullptr) {
      // The head on each row by a warp (its weights in registers, loaded
      // once), into hv [kRows][3] over `red`; then the epilogue, a thread a
      // row.
      float whr[3][kW / 32];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < kW / 32; ++i) whr[j][i] = __ldg(p.wh + j * kW + lane + 32 * i);
      float* hv = red;
      for (int r = warp; r < kRows; r += kCons / 32) {
        if (row0 + r >= p.n) break;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kW / 32; ++i) s = fmaf(to_f(A(r, lane + 32 * i)), whr[j][i], s);
          s = warp_sum(s) + p.bh[j];
          if (lane == 0) hv[r * 3 + j] = s;
        }
      }
      cons_sync();
      if (tid < kRows && row0 + tid < p.n) {
        const size_t o = static_cast<size_t>(row0 + tid) * 3;
        float out[3], drd[3], drt[3];
        rgb_epilogue(hv + tid * 3, p.rgbe.rawd + o, p.rgbe.rawt + o, p.rgbe, out, p.rgb_bar + o,
                     hb + tid * 3, drd, drt);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          p.drawd[o + c] = drd[c];
          p.drawt[o + c] = drt[c];
        }
      }
      cons_sync();
    }
  }

  // 3. The head gradients that read y: dwd, dwh, dbh. At width 128 each
  // warpgroup sums its tile's rows of column c, and tile 0's sum adds tile
  // 1's through `red`.
  if constexpr (W == kW) {
    const int c = tid;
    if (p.wd != nullptr) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(sb[r], to_f(A(r, c)), s);
      vec[o_dwd + c] = s;
    }
    for (int j = 0; j < p.hf; ++j) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(hb[r * p.hf + j], to_f(A(r, c)), s);
      vec[o_dwh + j * kW + c] = s;
    }
    if (c < p.hf) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += hb[r * p.hf + c];
      vec[o_dbh + c] = s;
    }
  } else {
    const int c = tid & (W - 1);
    const auto sum2 = [&](float s, float* out) {  // tile 0's s + tile 1's s
      red[tid] = s;
      cons_sync();
      if (tid < W) *out = red[c] + red[W + c];
      cons_sync();
    };
    if (p.wd != nullptr) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(sbt[r], to_f(A(r, c)), s);
      sum2(s, vec + o_dwd + c);
    }
    for (int j = 0; j < p.hf; ++j) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(hbt[r * p.hf + j], to_f(A(r, c)), s);
      sum2(s, vec + o_dwh + j * W + c);
    }
    if (tid < p.hf) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += hb[r * p.hf + tid];
      vec[o_dbh + tid] = s;
    }
  }
  PHASE_MARK(2, kScal);

  // 4. With u's cotangent, the inner chain: s_{L-1} = relu'(h) cdt(wd),
  // s_{l-1} = relu'(h_{l-1}) cdt(s_l Wa_l), each to the scratch.
  if constexpr (W == kW) {  // no cotangent of u at width 128
    if (dg) {
      settle();
      {
        const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = fc + 8 * j;
          const float q0 = round_t<bf16>(p.wd[c]), q1 = round_t<bf16>(p.wd[c + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            put2(fr + 8 * h, c, bit_at(mk, i) ? q0 : 0.f, bit_at(mk, i + 1) ? q1 : 0.f);
          }
        }
      }
      publish();
      store_act(&m.ss, (p.depth - 1) * rp + row0);
      PHASE_MARK(3, kScal);
      for (int l = p.depth - 1; l > 0; --l) {
        product<W>(acc, act_s, W / 64, act_s, W, ring_st);
        PHASE_MARK(3, kProd);
        settle();
        const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            put2(fr + 8 * h, fc + 8 * j, bit_at(mk, i) ? round_t<bf16>(acc[i]) : 0.f,
                   bit_at(mk, i + 1) ? round_t<bf16>(acc[i + 1]) : 0.f);
          }
        publish();
        store_act(&m.ss, (l - 1) * rp + row0);
        PHASE_MARK(3, kScal);
      }
    }
  }

  // 5. The head backward: g = cdt(cbar wc^T) + cdt(g32), g32 = sbar wd +
  // hbar wh^T; with K11 g = cdt(ybar + cdt(g32)). zeta_{L-1} = relu'(h) g,
  // and db_{L-1} its column sums. g32 of this thread's 64 elements goes head
  // by head (each head weight loaded once a thread, not once an element),
  // in trunk_bwd.cu's order of operations.
  float g3[64];
  {
#pragma unroll
    for (int i = 0; i < 64; ++i) g3[i] = 0.f;
    for (int j = 0; j < p.hf; ++j) {
      const float h0 = hbt[fr * p.hf + j], h1 = hbt[(fr + 8) * p.hf + j];
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float wv = __ldg(p.wh + j * W + fc + 8 * q + e);
          g3[4 * q + e] = fmaf(h0, wv, g3[4 * q + e]);
          g3[4 * q + 2 + e] = fmaf(h1, wv, g3[4 * q + 2 + e]);
        }
    }
    if (p.wd != nullptr) {
      const float s0 = sbt[fr], s1 = sbt[fr + 8];
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float wv = __ldg(p.wd + fc + 8 * q + e);
          g3[4 * q + e] = s0 * wv + g3[4 * q + e];
          g3[4 * q + 2 + e] = s1 * wv + g3[4 * q + 2 + e];
        }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) g3[i] = round_t<bf16>(g3[i]);
  }
  float cs[16][2];
  settle();
  if constexpr (HC > 0) {
    const bf16* cbar = static_cast<const bf16*>(p.cbar);
    for (int i = tid; i < kRows * (HC / 8); i += kCons) {  // 16-byte chunks
      const int r = i / (HC / 8), q = i % (HC / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (cbar != nullptr && row0 + r < p.n)
        v = *reinterpret_cast<const uint4*>(cbar + static_cast<size_t>(row0 + r) * HC + 8 * q);
      *reinterpret_cast<uint4*>(act + sw_off(r, 8 * q)) = v;
    }
    publish();
    PHASE_MARK(4, kScal);
    if (tid == 0) {
      for (int b = 0; b < HC / 64; ++b) tma_store(&m.cs, act_s + b * kBlk, 64 * b, row0);
      bulk_commit();
    }
    PHASE_MARK(4, kStore);
    if (tid < HC) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += to_f(A(r, tid));
      vec[o_dbc + tid] = s;
    }
    product(acc, act_s, HC / 64, act_s, HC, ring_st);
    PHASE_MARK(4, kProd);
    settle();
  }
  {
    const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h, r = fr + 8 * h, c = fc + 8 * j;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float gv;
          if constexpr (HC > 0) {
            gv = round_t<bf16>(round_t<bf16>(acc[i + e]) + g3[i + e]);
          } else if constexpr (YO) {
            const float yb = row0 + r < p.n
                ? to_f(static_cast<const bf16*>(p.ybar)[static_cast<size_t>(row0 + r) * kW + c + e])
                : 0.f;
            gv = round_t<bf16>(yb + g3[i + e]);
          } else {
            gv = g3[i + e];
          }
          v[e] = bit_at(mk, i + e) ? gv : 0.f;
          cs[j][e] += v[e];
        }
        put2(r, c, v[0], v[1]);
      }
    }
  }
  publish();
  store_act(&m.zs, (p.depth - 1) * rp + row0);
  col_sums<W>(cs, red, vec + (p.depth - 1) * W, W, false);
  PHASE_MARK(4, kScal);

  // 6. The first-order reverse: dx, zeta_{l-1} = relu'(h_{l-1}) cdt(zeta_l
  // Wa_l), db_{l-1}.
  [[maybe_unused]] float* dsh = reinterpret_cast<float*>(inb);  // K8: [kRows][dide]
  for (int l = p.depth - 1; l >= 0; --l) {
    if constexpr (W != kW) {
      if (p.dx0 != nullptr && l == p.skip) {
        // Width 128: zeta_skip kept in the tile's input blocks (free after
        // the recompute at this width; the C entry asks for kin >= 128)
        // until l = 0, in place of the f32 scratch of its dx share.
        for (int i = tid & 127; i < (W / 64) * kBlk / 16; i += 128)
          reinterpret_cast<uint4*>(inb_t)[i] = reinterpret_cast<const uint4*>(act_t)[i];
      }
      if (p.dx0 != nullptr && l == 0) {
        // dx = [zeta_skip | zeta_0] [Wx_skip ; Wx_0], one f32 sum, in
        // passes over the kin input columns, 128 at a time (no IDE block
        // here); a pair of dx0 columns goes as one store.
        const int t0 = row0 + kRows * wg;  // the tile's first sample
        for (int cx = 0; cx < p.kin; cx += W) {
          if (p.skip >= 0)
            product<W>(acc, inb_s, W / 64, act_s, 2 * W, ring_st);
          else
            product<W>(acc, act_s, W / 64, act_s, W, ring_st);
          PHASE_MARK(5, kProd);
#pragma unroll
          for (int i = 0; i < 64; i += 2) {
            const int r = fr + 8 * ((i >> 1) & 1), c = cx + fc + 8 * (i >> 2);
            const size_t gr = static_cast<size_t>(t0 + r);
            if (c >= p.kin || t0 + r >= p.n) continue;
            if (c + 1 < p.d0 && (p.d0 & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dx0) + gr * p.d0 + c) =
                  __floats2bfloat162_rn(acc[i], acc[i + 1]);
              continue;
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ce = c + e;
              if (ce >= p.d0 + p.d1) continue;
              if (ce < p.d0)
                static_cast<bf16*>(p.dx0)[gr * p.d0 + ce] = from_f<bf16>(acc[i + e]);
              else
                static_cast<bf16*>(p.dx1)[gr * p.d1 + (ce - p.d0)] = from_f<bf16>(acc[i + e]);
            }
          }
          PHASE_MARK(5, kStore);
        }
      }
    } else {
      if (p.dx0 != nullptr && (l == 0 || l == p.skip)) {
        // dx = (0 + zeta_skip Wx_skip) + zeta_0 Wx_0 in f32, the skip layer's
        // share in the f32 scratch; with K8 the IDE block's cotangents to dsh.
        product(acc, act_s, kW / 64, act_s, kW, ring_st);
        PHASE_MARK(5, kProd);
        const int dide = DIR ? p.dir.width() : 0, fin = p.d0 + dide + p.d1;
        if (l == 0 && DIR) settle();  // dsh overwrites the input tile
        // Element pairs (i, i + 1) sit at columns (c, c + 1) of one row; at l
        // = 0 the skip layer's share of 8 pairs is loaded before any is used.
#pragma unroll
        for (int q = 0; q < 64; q += 16) {
          float2 kv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = q + 2 * u, r = fr + 8 * ((i >> 1) & 1), c = fc + 8 * (i >> 2);
            kv[u] = make_float2(0.f, 0.f);
            if (l == 0 && p.skip >= 0 && c < p.kin)
              kv[u] = *reinterpret_cast<const float2*>(p.dxs + static_cast<size_t>(row0 + r) * p.kin + c);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = q + 2 * u, r = fr + 8 * ((i >> 1) & 1), c = fc + 8 * (i >> 2);
            if (c >= p.kin) continue;
            if (l != 0) {
              *reinterpret_cast<float2*>(p.dxs + static_cast<size_t>(row0 + r) * p.kin + c) =
                  make_float2(acc[i], acc[i + 1]);
              continue;
            }
            const size_t gr = static_cast<size_t>(row0 + r);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = p.skip >= 0 ? (e ? kv[u].y : kv[u].x) + acc[i + e] : acc[i + e];
              const int ce = c + e, ci = ce - p.d0;
              if (DIR && ci >= 0 && ci < dide) {
                dsh[r * dide + ci] = v;
                continue;
              }
              if (row0 + r >= p.n || ce >= fin) continue;
              if (ce < p.d0)
                static_cast<bf16*>(p.dx0)[gr * p.d0 + ce] = from_f<bf16>(v);
              else
                static_cast<bf16*>(p.dx1)[gr * p.d1 + (ci - dide)] = from_f<bf16>(v);
            }
          }
        }
        PHASE_MARK(5, kStore);
      }
    }
    if (l > 0) {
      product<W>(acc, act_s, W / 64, act_s, W, ring_st);
      PHASE_MARK(5, kProd);
      settle();
      const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const float v0 = bit_at(mk, i) ? round_t<bf16>(acc[i]) : 0.f;
          const float v1 = bit_at(mk, i + 1) ? round_t<bf16>(acc[i + 1]) : 0.f;
          cs[j][0] += v0;
          cs[j][1] += v1;
          put2(fr + 8 * h, fc + 8 * j, v0, v1);
        }
      }
      publish();
      store_act(&m.zs, (l - 1) * rp + row0);
      col_sums<W>(cs, red, vec + (l - 1) * W, W, false);
      PHASE_MARK(5, kScal);
    }
  }

  // 6b. K8/K9: the IDE block's cotangents back to the raw inputs.
  if constexpr (DIR) {
    if (p.dir.p) {
      cons_sync();
      ide_backward(p.dir, dsh, p.dir.width(), row0, p.n, p.ddg, p.ddk);
    }
  }
  PHASE_MARK(5, kScal);

  // 7. With u's cotangent, the tangent chain: ts = (cdt(t xc), cdt(-t xs))
  // replaces x in the input tile; p_l = relu'(h_l) cdt([p_{l-1} | ts] W_l),
  // to the scratch but the last, whose column sums add to dwd.
  if constexpr (W == kW) {  // no cotangent of u at width 128
    if (dg) {
      settle();
      const int F = p.d0;
      for (int i = tid; i < kRows * F; i += kCons) {
        const int r = i / F, c = i % F;
        float tp = 0.f;
        for (int j = 0; j < p.nb; ++j) tp = fmaf(ub[r * p.nb + j], p.fold[c * p.nb + j], tp);
        if constexpr (SPA) {
          if (p.ipe.lm != nullptr) {  // K7: the f32 factors
            float e = 0.f, sn = 0.f, cs_ = 0.f;
            if (row0 + r < p.n) ipe_trig(p.ipe, row0 + r, c, e, sn, cs_);
            const float te = mul(tp, e);
            X(r, c) = from_f<bf16>(mul(te, cs_));
            X(r, F + c) = from_f<bf16>(-mul(te, sn));
            continue;
          }
        }
        const float xs = to_f(X(r, c)), xc = to_f(X(r, F + c));
        X(r, c) = from_f<bf16>(tp * xc);
        X(r, F + c) = from_f<bf16>(-(tp * xs));
      }
      publish();
      PHASE_MARK(6, kScal);
      store_in(&m.ts);
      PHASE_MARK(6, kStore);
      for (int l = 0; l < p.depth; ++l) {
        if (l == 0)
          product<W>(acc, inb_s, kp / 64, inb_s, p.kin, ring_st);
        else
          product<W>(acc, act_s, W / 64, inb_s, k_dim<W>(p, l), ring_st);
        PHASE_MARK(6, kProd);
        settle();
        const uint2 mk = masks[l * kCons + tid];
        const bool last = l + 1 == p.depth;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            const float v0 = bit_at(mk, i) ? round_t<bf16>(acc[i]) : 0.f;
            const float v1 = bit_at(mk, i + 1) ? round_t<bf16>(acc[i + 1]) : 0.f;
            cs[j][0] += v0;
            cs[j][1] += v1;
            if (!last) put2(fr + 8 * h, fc + 8 * j, v0, v1);
          }
        }
        if (!last) {
          publish();
          store_act(&m.ps, l * rp + row0);
          PHASE_MARK(6, kStore);
        } else {
          col_sums<W>(cs, red, vec + o_dwd, W, true);
          PHASE_MARK(6, kScal);
        }
      }
    }
  }
  if (tid == 0) bulk_wait();
}


// Shared memory of a launch; fused_mlp.py `kernel_smem` mirrors the
// wide-input instance's sum (WIDE: two chunks in the input tile's place;
// DG: a 3-stage ring and the fold).
template <int W, bool WIDE = false, bool DG = false>
size_t tma_smem(const BwdParams& p) {
  const int kp = WIDE ? 2 * kWideChunk : (p.kin + kBK - 1) / kBK * kBK;
  constexpr int ns = WIDE ? wide_stages(DG) : kStages;
  return 1024 + static_cast<size_t>(ns) * kSliceW<W> +
         (DG ? 4 * static_cast<size_t>(p.d0) * p.nb : 0) +
         kTiles<W> * (W / 64 + kp / 64) * kBlk + 8 * static_cast<size_t>(p.depth) * kCons +
         4 * 4 * kCons + 4 * static_cast<size_t>(kRows * kTiles<W>) * (1 + p.hf + p.nb) + 8 +
         16 * ns;
}

template <int HC, bool DIR, bool SPA, bool YO, int W = kW, bool WIDE = false, bool DG = false>
int launch_tma(const BwdParams& p, int hc, cudaStream_t stream) {
  if (p.depth > kMaxDepth || p.kin > (WIDE ? kWideKin : kW) || hc != HC ||
      p.rp % (kRows * kTiles<W>) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The wide-input instance runs no dx, and the cotangent of u in DG alone.
  if (WIDE && (p.dx0 != nullptr || (p.ubar != nullptr) != DG))
    return static_cast<int>(cudaErrorInvalidValue);
  // Width 128 keeps zeta_skip in each tile's input blocks: at least W wide.
  if (W != kW && p.kin < W) return static_cast<int>(cudaErrorInvalidValue);
  // K6's scratch ([kRows] + [8 warps][S] floats) and K8's f32 cotangents
  // must fit in the activation and input tiles.
  const int kp = (p.kin + kBK - 1) / kBK * kBK;
  if (SPA && p.wbar != nullptr && 4 * (kRows + (kCons / 32) * p.samples) > (kW / 64) * kBlk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (DIR && p.dir.p && 4 * p.dir.width() > 2 * kp) return static_cast<int>(cudaErrorInvalidValue);
  TmaMaps m;
  memset(&m, 0, sizeof(m));
  const bf16* w = static_cast<const bf16*>(p.w);
  const bf16* wt = static_cast<const bf16*>(p.wt);
  size_t off = 0;
  bool ok = true;
  for (int l = 0; l < p.depth; ++l) {
    const int K = l == 0 ? p.kin : (l == p.skip ? W + p.kin : W);
    ok = ok && make_map(&m.w[l], w + off, K, W, K, W) && make_map(&m.wt[l], wt + off, W, K, W, W);
    off += static_cast<size_t>(W) * K;
  }
  const int rows = p.depth * p.rp;
  ok = ok && make_map(&m.hs, p.hs, W, rows, W, kRows) && make_map(&m.zs, p.zs, W, rows, W, kRows) &&
       make_map(&m.xs, p.xs, p.kin, p.rp, p.kin, kRows);
  if (HC > 0)
    ok = ok && make_map(&m.wct, p.wct, HC, kW, HC, kW) && make_map(&m.cs, p.cs, HC, p.rp, HC, kRows);
  if (p.ubar != nullptr)
    ok = ok && make_map(&m.ss, p.ss, kW, rows, kW, kRows) &&
         make_map(&m.ps, p.ps, kW, rows, kW, kRows) &&
         make_map(&m.ts, p.ts, p.kin, p.rp, p.kin, kRows);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tma_smem<W, WIDE, DG>(p);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(trunk_bwd_tma_kernel<HC, DIR, SPA, YO, W, WIDE, DG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_bwd_tma_kernel<HC, DIR, SPA, YO, W, WIDE, DG>
      <<<p.rp / (kRows * kTiles<W>), kTmaThreads, smem, stream>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The weight-gradient product: out[split][M][N] = sum over the split's
// samples of Z^T [A | X] (+ S^T [PA | TX]), every operand sample-major
// [rp][features] in device memory. A CTA: a 128 x 128 output tile, two
// consumer warpgroups of 64 rows each, one producer warp; the samples are
// wgmma's K, 64 a stage, and both operands enter MN-major (transposed).

constexpr int kWgStages = 3;
constexpr int kBox = 64 * 128;  // bytes of a [64 samples][64 features] box

struct WgradMaps {
  CUtensorMap z, a, x, s, pa, tx;
};

struct WgradTma {
  int M, N, ncut, rp, ksplit, tiles_m;
  bool two;
  float* out;
};

__global__ void __launch_bounds__(kTmaThreads, 1)
    wgrad_tma_kernel(const __grid_constant__ WgradTma p, const __grid_constant__ WgradMaps m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr int kStage = 8 * kBox;  // Z (2 boxes) | A (2) | S (2) | PA (2)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kWgStages * kStage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring r{smem_u32(smem), smem_u32(bars), smem_u32(bars + kWgStages), kWgStages, 0, 0u};
  const int m0 = (blockIdx.x % p.tiles_m) * 128, n0 = (blockIdx.x / p.tiles_m) * 128;
  const int kb = blockIdx.y * p.ksplit;
  const int ke = min(kb + p.ksplit, p.rp);
  const int ns = (ke - kb) / 64;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons / 32) {
    if (lane == 0) {
      const bool in_a = n0 < p.ncut;
      const CUtensorMap* b1 = in_a ? &m.a : &m.x;
      const CUtensorMap* b2 = in_a ? &m.pa : &m.tx;
      const int bc = in_a ? n0 : n0 - p.ncut;
      const uint32_t bytes = (p.two ? 8 : 4) * kBox;
      for (int s = 0; s < ns; ++s) {
        const int k0 = kb + 64 * s;
        mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
        const uint32_t full = r.full + 8 * r.stage, dst = r.base + r.stage * kStage;
        mbar_expect_tx(full, bytes);
        for (int h = 0; h < 2; ++h) {
          tma_load(dst + h * kBox, &m.z, full, m0 + 64 * h, k0);
          tma_load(dst + (2 + h) * kBox, b1, full, bc + 64 * h, k0);
          if (p.two) {
            tma_load(dst + (4 + h) * kBox, &m.s, full, m0 + 64 * h, k0);
            tma_load(dst + (6 + h) * kBox, b2, full, bc + 64 * h, k0);
          }
        }
        r.advance();
      }
    }
    return;
  }

  const int wg = tid >> 7;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int prev = 0;
  wg_fence();
  for (int s = 0; s < ns; ++s) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t st = r.base + r.stage * kStage;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma128<1, 1>(acc, sw128_desc(st + wg * kBox + kk * 2048, kBox, 1024),
                     sw128_desc(st + 2 * kBox + kk * 2048, kBox, 1024), 1);
      if (p.two)
        wgmma128<1, 1>(acc, sw128_desc(st + (4 + wg) * kBox + kk * 2048, kBox, 1024),
                       sw128_desc(st + 6 * kBox + kk * 2048, kBox, 1024), 1);
    }
    wg_commit();
    if (s > 0) {
      wg_wait<1>();
      if (lane == 0) mbar_arrive(r.empty + 8 * prev);
    }
    prev = r.stage;
    r.advance();
  }
  wg_wait<0>();
  acc_fence(acc);

  const int row = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  float* out = p.out + static_cast<size_t>(blockIdx.y) * p.M * p.N;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 8 * j + 2 * (lane & 3), rr = row + 8 * h;
      if (rr < p.M && col < p.N)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(rr) * p.N + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

}  // namespace

// Plain C entries for ctypes, as trunk_bwd.cu's: each returns the
// cudaError_t of its launch (0 on success), allocates nothing and does not
// synchronise; all run on `stream`.

// The per-tile backward of refnerf_trunk_bwd (the same arguments), for the
// bf16 trunk (dtype 1) of at most 8 layers and 256 input columns: at width
// 256 K4 (hc 128; with K6/K7, SPA), K5 (hc 0; with K8-K10, DIR) and K11's y
// cotangent (YO); at width 128 the plain K5 alone (hc 0, no density head,
// fused stage, cotangent of u or y) on at least 128 input columns, 128
// samples a CTA, so rp a multiple of 128 (dxs unused there); past 256 and
// up to kWideKin input columns K4 at width 256 with the density head, f32
// heads and the compute-dtype head (hc 0, 128 or 256), with or without the
// cotangent of u (nb <= kMaxNbWide), no fused stage, y or dx (the wide-input
// instance). The weight-gradient operands go to the scratch sample-major,
// [rp][features] per region (h, zeta, s, p: [depth][rp][W]; x, ts:
// [rp][kin]; cbar: [rp][hc]), for refnerf_wgrad_tma; the vector gradients
// one row a CTA.
extern "C" int refnerf_trunk_bwd_tma(REFNERF_BWD_ARGS) {
  BwdParams p;
  const int err = bwd_params(p, REFNERF_BWD_NAMES);
  if (err != 0) return err;
  if (dtype != 1 || (width != kW && width != 128)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dir = p.dir.p != 0 || p.rgb_bar != nullptr;
  const bool spa = p.ipe.lm != nullptr || p.wbar != nullptr;
  if (width == 128)
    return hc == 0 && !dir && !spa && p.ubar == nullptr && p.wd == nullptr && p.ybar == nullptr
               ? launch_tma<0, false, false, false, 128>(p, hc, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (p.kin > kW) {  // the wide-input instance: the heads, the cotangent of u, no dx
    if (dir || spa || p.ybar != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // The tangent reads the segments' values in pairs: d0 even, the bases
    // 4-byte aligned.
    if (p.ubar != nullptr &&
        ((p.d0 & 1) || ((reinterpret_cast<uintptr_t>(p.x0) | reinterpret_cast<uintptr_t>(p.x1)) & 3)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (p.ubar != nullptr)
      return hc == 0     ? launch_tma<0, false, false, false, kW, true, true>(p, hc, s)
             : hc == 128 ? launch_tma<128, false, false, false, kW, true, true>(p, hc, s)
             : hc == 256 ? launch_tma<256, false, false, false, kW, true, true>(p, hc, s)
                         : static_cast<int>(cudaErrorInvalidValue);
    return hc == 0     ? launch_tma<0, false, false, false, kW, true>(p, hc, s)
           : hc == 128 ? launch_tma<128, false, false, false, kW, true>(p, hc, s)
           : hc == 256 ? launch_tma<256, false, false, false, kW, true>(p, hc, s)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.ybar != nullptr)
    return hc == 0 && !dir && !spa && p.ubar == nullptr
               ? launch_tma<0, false, false, true>(p, hc, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (hc == 0 && !spa)
    return dir ? launch_tma<0, true, false, false>(p, hc, s)
               : launch_tma<0, false, false, false>(p, hc, s);
  if (hc == 128 && !dir)
    return spa ? launch_tma<128, false, true, false>(p, hc, s)
               : launch_tma<128, false, false, false>(p, hc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Per-split partials out[split][M][N] of dW = Z^T [A | X] (+ S^T [PA | TX])
// over rp samples, as refnerf_wgrad (the same arguments) but every operand
// sample-major: z [rp][M], a [rp][ncut], x [rp][N - ncut], s [rp][M], pa
// [rp][ncut], tx [rp][N - ncut]. bf16 (dtype 1) only; M and ncut multiples
// of 128, rp and ksplit of 64.
extern "C" int refnerf_wgrad_tma(int dtype, int M, int N, int ncut, int rp, int ksplit,
                                 const void* z, const void* a, const void* x, const void* s,
                                 const void* pa, const void* tx, float* out, void* stream) {
  if (dtype != 1 || M <= 0 || M % 128 != 0 || N <= 0 || ncut < 0 || ncut > N || ncut % 128 != 0 ||
      rp <= 0 || rp % 64 != 0 || ksplit <= 0 || ksplit % 64 != 0 || z == nullptr ||
      (ncut > 0 && a == nullptr) || (ncut < N && x == nullptr) ||
      (s != nullptr && ((ncut > 0 && pa == nullptr) || (ncut < N && tx == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  WgradMaps m;
  memset(&m, 0, sizeof(m));
  bool ok = make_map(&m.z, z, M, rp, M, 64);
  if (ncut > 0) ok = ok && make_map(&m.a, a, ncut, rp, ncut, 64);
  if (ncut < N) ok = ok && make_map(&m.x, x, N - ncut, rp, N - ncut, 64);
  if (s != nullptr) {
    ok = ok && make_map(&m.s, s, M, rp, M, 64);
    if (ncut > 0) ok = ok && make_map(&m.pa, pa, ncut, rp, ncut, 64);
    if (ncut < N) ok = ok && make_map(&m.tx, tx, N - ncut, rp, N - ncut, 64);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_m = M / 128, tiles_n = (N + 127) / 128;
  const WgradTma p{M, N, ncut, rp, ksplit, tiles_m, s != nullptr, out};
  const size_t smem = 1024 + static_cast<size_t>(kWgStages) * 8 * kBox + 16 * kWgStages;
  cudaError_t err = cudaFuncSetAttribute(wgrad_tma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_m * tiles_n, (rp + ksplit - 1) / ksplit);
  wgrad_tma_kernel<<<grid, kTmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}


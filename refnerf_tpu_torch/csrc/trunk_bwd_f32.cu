// The f32 trunk backward for Hopper (sm_90a) at widths 256 and 128:
// register-blocked FMA products fed by a TMA weight ring, and a
// register-blocked FMA weight-gradient product fed by TMA.
//
// Replaces, for the compute dtype float32 at width 256 (up to 8 layers and
// 256 input columns), the backward Pallas kernel `_bwd_kernel` (:668-853)
// of refnerf_tpu/ops/pallas/fused_mlp.py in the modes of trunk_bwd.cu (K4
// with and without u's cotangent, K5 with dx, K6/K7 in K4, K8-K10 in K5,
// K11's y cotangent), and at width 128 in the plain K5 (mip-NeRF's
// directional trunk, up to 8 layers and as many input columns as shared
// memory holds: 192), with the same arithmetic (trunk_bwd.cu:35-43) and the
// same C arguments, but for the head: this library reads the compute-dtype
// head untransposed, wc [HC][W], through the `wct` argument. Every product
// runs in full f32 on the FMA pipes (no TF32: trunk_common.cuh). The
// trunks past these shapes stay in trunk_bwd.cu.
//
// Bound on the H100: K4 with u's cotangent needs 3.2 TFLOP at N = 524,288
// samples (chip_smoke.py `trunk_flops`), 47 ms at 67 TFLOP/s; K5 1.8 TFLOP,
// 26 ms; K5 at width 128 0.49 TFLOP, 7.3 ms. The weight-gradient operands
// (h, zeta, s, p, x, ts, cbar: ~34 KB a sample for K4 with u's cotangent
// in f32, ~17 KB for K5, ~8.9 KB for K5 at width 128) are written once and
// read about once: ~36, ~18 and ~9.3 GB a launch, 11, 5.4 and 2.8 ms at
// 3.35 TB/s, under the products' bound. A 64-row tile reads each layer's
// f32 weights (256 KB) from L2 for 8.4 MFLOP, 32 FLOP a byte: ~2.1 TB/s at
// the FMA peak, within L2's reach, so one tile a CTA at width 256. At
// width 128 a tile's product over a slice is half as large while each
// slice still costs its wait and its arrive, so a CTA holds two tiles that
// share each [16][128] slice (64 FLOP a byte of weights).
//
// Design.
//  - Two consumer warpgroups and one producer warp a CTA of 64 samples
//    (128 at width 128: two tiles as one). Each product acc[R][W] =
//    A[R][K] B[K][W] is an outer product over K: each consumer thread owns
//    an 8 x 8 block of outputs (rows R(i) = rb + i % 4 + 16 (i / 4),
//    columns C(j) = cb + j % 4 + 32 (j / 4); a warp 32 rows x 64 columns:
//    the 8 warps 2 row halves x 4 column quarters at width 256, 4 row
//    quarters, two a tile, x 2 column halves at 128), and each k step reads
//    its 8 values of A and of B as four LDS.128 for 64 FFMA.
//  - Every operand sits with the contraction index outermost ("k-major"):
//    the activation and input tiles feature-major, [feature][R samples]
//    (rows padded to R + 4 floats, so that neither an epilogue's column
//    stores nor a product's row loads conflict in the banks), and the
//    weights as the pack whose rows are the contraction: `wt` [K_l][W] for
//    the forward products (recompute, tangent), `w` [W][K_l] for the reverse
//    ones (zeta_l W_l, s_l W_l, dx), wc [HC][W] for the head. Each epilogue
//    writes its tile feature-major for the next product.
//  - The weights come by TMA (cp.async.bulk.tensor, one tensor map a layer
//    and pack, its extent exact: a box past it reads zeros) in 16-deep
//    slices of W columns (16 or 8 KB) through a ring of as many stages as
//    shared memory holds (4 to 8) with full/empty mbarriers; at width 128
//    dx's products run in passes of 128 input columns, a last one over at
//    most 64 on `product_half` (8 x 4 a thread). The producer
//    warp walks the consumers' schedule of products (`schedule`), so no CTA
//    barrier paces a slice and the next product's weights load during an
//    epilogue.
//  - The scalar passes live in the products' epilogues, in registers: the
//    bias, ReLU, relu' masks (64 bits a thread and layer, in the block's own
//    order), the bias gradients' column sums (shuffles over the 4 lanes of
//    a column, then the two warp rows in order: no serial 64-row loop), the
//    density and f32 heads' gradients from y. With one CTA an SM no other
//    warps hide a load's latency, so the loops that read device memory
//    (dx's skip share, K7's lifted inputs) issue every load before using
//    one.
//  - The weight-gradient operands leave sample-major ([rows][features])
//    from registers, two 16-byte stores a row; wgrad_f32_kernel reads them by
//    TMA, 32 samples a stage, and runs the same 8 x 8 register-blocked outer
//    product over samples on 128 x 128 output tiles, a partial per split of
//    samples; reduce_kernel (trunk_bwd.cu) sums the partials in a fixed
//    order. No float atomics: the gradients do not depend on the schedule.
//    At width 128 the bias gradients' column sums add tile 0's rows, then
//    tile 1's, into one row of partials a CTA.
// One CTA an SM (~120-230 KB of shared memory).

#define PHASE_SYNC() cons_sync()  // closes a stamped segment
#include "trunk_f32.cuh"
#include "trunk_bwd_args.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kMinStages = 4;

template <int W>
__device__ __forceinline__ int k_dim(const BwdParams& p, int l) {
  return l == 0 ? p.kin : (l == p.skip ? W + p.kin : W);
}

// The products of one CTA in order, as (tensor map, first column, K rows);
// the producer loads their slices, and the kernel below runs them in this
// order. At width 128 dx's products cover the kin input columns in passes
// of 128.
template <int HC, int W, typename F>
__device__ void schedule(const BwdParams& p, const MapsF32& m, F&& load) {
  const bool dg = p.ubar != nullptr, dx = p.dx0 != nullptr;
  for (int l = 0; l < p.depth; ++l) load(&m.wt[l], 0, k_dim<W>(p, l));  // recompute
  if (dg)
    for (int l = p.depth - 1; l > 0; --l) load(&m.w[l], 0, W);  // inner chain
  if (HC > 0) load(&m.wc, 0, HC);                               // head backward
  for (int l = p.depth - 1; l >= 0; --l) {                      // first-order reverse
    if (dx && (l == 0 || l == p.skip)) {
      if constexpr (W == kW)
        load(&m.w[l], l == 0 ? 0 : kW, kW);
      else
        for (int cx = 0; cx < p.kin; cx += W) load(&m.w[l], (l == 0 ? 0 : W) + cx, W);
    }
    if (l > 0) load(&m.w[l], 0, W);
  }
  if (dg)
    for (int l = 0; l < p.depth; ++l) load(&m.wt[l], 0, k_dim<W>(p, l));  // tangent
}

// The block into the CTA's rows of a sample-major [rows][W] scratch (g at
// the CTA's first row): two 16-byte stores a row.
template <int W>
__device__ __forceinline__ void put_rows(float* g, const Block& v, int rb, int cb) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* d = g + static_cast<size_t>(rb + row_of(i)) * W + cb;
    *reinterpret_cast<float4*>(d) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    *reinterpret_cast<float4*>(d + 32) = make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
  }
}

// out[c] = (add ? out[c] : 0) + the sum over the CTA's rows of column c,
// from cs[j], this thread's sum over its 8 rows of column cb + C(j):
// shuffles over the 4 lanes of a column, then the warp rows in order
// through red [R / 32][W] (at width 128 tile 0's two, then tile 1's). All
// consumers call it.
template <int W>
__device__ void col_sums(const float (&cs)[8], float* red, float* out, bool add, int wm, int cb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v = cs[j];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 8) red[wm * W + cb + col_of(j)] = v;
  }
  cons_sync();
  const int c = threadIdx.x;
  if constexpr (W == kW) {
    const float s = red[c] + red[kW + c];
    out[c] = add ? out[c] + s : s;
  } else if (c < W) {
    const float s = (red[c] + red[W + c]) + (red[2 * W + c] + red[3 * W + c]);
    out[c] = add ? out[c] + s : s;
  }
  cons_sync();
}

// The k-major input tile into the CTA's rows of a sample-major [rows][kin]
// scratch (g at the CTA's first row), four columns a store.
template <int W>
__device__ void store_in(float* g, const float* t, int kin) {
  constexpr int R = kRowsW<W>, LD = kLDW<W>;
  const int q4 = kin / 4;
  for (int i = threadIdx.x; i < R * q4; i += kCons) {
    const int r = i / q4, c = 4 * (i % q4);
    *reinterpret_cast<float4*>(g + static_cast<size_t>(r) * kin + c) =
        make_float4(t[c * LD + r], t[(c + 1) * LD + r], t[(c + 2) * LD + r],
                    t[(c + 3) * LD + r]);
  }
}

// DG on the wide-input instance: columns [c0, c0 + kc) (kc a multiple of
// 8) of the tangent of the trunk input, ts = (tp xc, -(tp xs)) with tp =
// ubar S^T (summed over the basis in order; ub the tile's rows of ubar
// [kRows][nb], fs the fold S [d0][nb], both in shared memory), into the
// k-major tile t [kc][kLD], the partner segment's value (xc for a sin
// column c, xs for a cos column d0 + c) read from device memory. A warp's
// lanes take 32 rows of one 8-column group: their reads of S are one
// address, those of ubar and their stores to t 32 banks, and a lane's 8 sums
// are independent. Zeros past the segments and past row n.
__device__ void ts_chunk(float* t, const BwdParams& p, const float* ub, const float* fs, int c0,
                         int kc, int row0) {
  const int F = p.d0, nb = p.nb;
  const float* x0 = static_cast<const float*>(p.x0);
  const float* x1 = static_cast<const float*>(p.x1);
  for (int i = threadIdx.x; i < kRows * (kc / 8); i += kCons) {
    const int r = i % kRows, c = 8 * (i / kRows), gr = row0 + r;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gr < p.n) {
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
      const size_t o = static_cast<size_t>(gr) * F;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = c0 + c + e;
        if (k < F)
          v[e] = tp[e] * __ldg(x1 + o + k);
        else if (k < 2 * F)
          v[e] = -(tp[e] * __ldg(x0 + o + (k - F)));
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) t[(c + e) * kLD + r] = v[e];
  }
}

// The wide-input instance (WIDE): the backward of the spatial trunk at
// width 256 on more than 256 input columns (up to kWideKin), with the
// density head and f32 heads (the bottleneck's and u's cotangents: HC and
// DG below; no fused stage, y or dx): mip-NeRF 360's proposal MLP. As the body below
// (steps 1-6 without their modes), but the recompute streams layer 0's
// input share, and the skip layer's, through a k-major [kChunk][kLD] tile
// (`fwd_f32_wide`), and writes each chunk of layer 0's input to the x
// scratch for the weight-gradient product.
//
// HC: the compute-dtype head's cotangent (128 or 256 wide: the MLP's
// bottleneck), the body's step 5. DG: the cotangent of u, the body's steps
// 4 and 7: the inner chain's s_l to the scratch, then the tangent chain,
// whose input ts = (tp xc, -(tp xs)), tp = ubar S^T, is made chunk by chunk
// in the chunk tile (`ts_chunk`, the partner segment's values read from
// device memory; at layer 0 each chunk also goes to the ts scratch) and made
// again at the skip layer.
template <int HC, bool DG>
__device__ __forceinline__ void bwd_f32_wide(const BwdParams& p, const MapsF32& m,
                                             unsigned char* smem) {
  constexpr int W = kW;
  const int kin = p.kin;
  float* ringp = reinterpret_cast<float*>(smem);               // stages x [16][256]
  float* act = ringp + m.stages * (kSD * W);                   // [256][kLD]: h, zeta
  float* chunk = act + W * kLD;                                // [kChunk][kLD]: input columns
  uint2* masks = reinterpret_cast<uint2*>(chunk + kChunk * kLD);  // [depth][256]
  float* red = reinterpret_cast<float*>(masks + p.depth * kCons);  // [2][W]
  float* sb = red + 2 * kW;                                    // [kRows]
  float* hb = sb + kRows;                                      // [kRows][hf]
  float* ub = hb + kRows * p.hf;                               // DG: [kRows][nb]
  float* fs = ub + (DG ? kRows * p.nb : 0);                    // DG: the fold [d0][nb]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(fs + (DG ? p.d0 * p.nb : 0)) + 7) &
      ~static_cast<uintptr_t>(7));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ring{smem_u32(ringp), smem_u32(bars), smem_u32(bars + m.stages), m.stages, 0, 0u};

  if (tid == 0) {
    for (int s = 0; s < m.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons / 32) {  // the producer: the recompute, then the reverse
    if constexpr (HC > 0 || DG) {
      if (lane == 0)
        schedule<HC, W>(p, m, [&](const CUtensorMap* map, int col, int K) {
          for (int k = 0; k < K; k += kSD) {
            mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
            mbar_expect_tx(ring.full + 8 * ring.stage, kSliceF);
            tma_load(ring.base + ring.stage * kSliceF, map, ring.full + 8 * ring.stage, col, k);
            ring.advance();
          }
        });
    } else if (lane == 0) {
      auto load = [&](const CUtensorMap* map, int K) {
        for (int k = 0; k < K; k += kSD) {
          mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
          mbar_expect_tx(ring.full + 8 * ring.stage, kSliceF);
          tma_load(ring.base + ring.stage * kSliceF, map, ring.full + 8 * ring.stage, 0, k);
          ring.advance();
        }
      };
      for (int l = 0; l < p.depth; ++l) load(&m.wt[l], k_dim<W>(p, l));
      for (int l = p.depth - 1; l > 0; --l) load(&m.w[l], W);
    }
    return;
  }

  PHASE_START;
  const int wm = warp >> 2;
  const int rb = 32 * wm + 4 * (lane >> 3);
  const int cb = 64 * (warp & 3) + 4 * (lane & 7);
  const int row0 = blockIdx.x * kRows;
  const size_t rp = static_cast<size_t>(p.rp);
  const float* bias = static_cast<const float*>(p.b);
  float* vec = p.vec + static_cast<size_t>(blockIdx.x) * p.nvec;
  const int o_dwd = p.depth * W;
  const int o_dwh = o_dwd + (p.wd != nullptr ? W : 0);
  const int o_dbh = o_dwh + p.hf * W;
  [[maybe_unused]] const int o_dbc = o_dbh + p.hf;
  auto rows_at = [&](void* region, int l) {
    return static_cast<float*>(region) + (l * rp + row0) * W;
  };
  float* xs = static_cast<float*>(p.xs) + row0 * static_cast<size_t>(kin);
  float acc[8][8];
  float cs[8];

  // 1. The cotangents.
  for (int r = tid; r < kRows; r += kCons)
    sb[r] = (p.sbar != nullptr && row0 + r < p.n) ? p.sbar[row0 + r] : 0.f;
  for (int i = tid; i < kRows * p.hf; i += kCons)
    hb[i] = (p.hbar != nullptr && row0 + i / p.hf < p.n)
                ? p.hbar[static_cast<size_t>(row0) * p.hf + i] : 0.f;
  if constexpr (DG) {
    for (int i = tid; i < kRows * p.nb; i += kCons)
      ub[i] = row0 + i / p.nb < p.n ? p.ubar[static_cast<size_t>(row0) * p.nb + i] : 0.f;
    for (int i = tid; i < p.d0 * p.nb; i += kCons) fs[i] = __ldg(p.fold + i);
  }
  PHASE_MARK(0, kScal);

  // acc += the input share, chunk by chunk; at layer 0 each chunk also goes
  // to the x scratch, four columns a store.
  auto input_share = [&](bool keep) {
    for (int c0 = 0; c0 < kin; c0 += kChunk) {
      const int kc = min(kChunk, kin - c0);
      cons_sync();  // every consumer is done with the last chunk
      load_input_cols(chunk, static_cast<const float*>(p.x0), p.d0,
                      static_cast<const float*>(p.x1), p.d1, c0, kc, row0, p.n);
      cons_sync();
      PHASE_MARK(0, kScal);
      if (keep) {
        const int q4 = kc / 4;
        for (int i = tid; i < kRows * q4; i += kCons) {
          const int r = i / q4, c = 4 * (i % q4);
          *reinterpret_cast<float4*>(xs + static_cast<size_t>(r) * kin + c0 + c) =
              make_float4(chunk[c * kLD + r], chunk[(c + 1) * kLD + r],
                          chunk[(c + 2) * kLD + r], chunk[(c + 3) * kLD + r]);
        }
        PHASE_MARK(0, kStore);
      }
      product_add(acc, chunk, kc, ring, ringp, rb, cb);
      PHASE_MARK(1, kProd);
    }
  };

  // 2. Recompute: h_l = relu(acc + b_l) to the tile and the scratch, relu'
  // masks as bits in the block's order. acc keeps y after the last layer.
  for (int l = 0; l < p.depth; ++l) {
    if (l == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    } else {
      product<W>(acc, act, W, act, W, ring, ringp, rb, cb);
      PHASE_MARK(1, kProd);
    }
    if (l == 0 || l == p.skip) input_share(l == 0);
    cons_sync();
    uint2 mk = make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = __ldg(bias + l * W + cb + col_of(j));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaxf(acc[i][j] + b, 0.f);
        const uint32_t bit = (acc[i][j] > 0.f ? 1u : 0u) << ((8 * i + j) & 31);
        if (i < 4) mk.x |= bit; else mk.y |= bit;
      }
    }
    masks[l * kCons + tid] = mk;
    put_tile<kLD>(act, acc, rb, cb);
    cons_sync();
    PHASE_MARK(1, kScal);
    put_rows<W>(rows_at(p.hs, l), acc, rb, cb);
    PHASE_MARK(1, kStore);
  }

  // 3. The head gradients that read y (acc): dwd, dwh by the column sums;
  // dbh.
  if (p.wd != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cs[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) cs[j] = fmaf(sb[rb + row_of(i)], acc[i][j], cs[j]);
    }
    col_sums<W>(cs, red, vec + o_dwd, false, wm, cb);
  }
  for (int h = 0; h < p.hf; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cs[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) cs[j] = fmaf(hb[(rb + row_of(i)) * p.hf + h], acc[i][j], cs[j]);
    }
    col_sums<W>(cs, red, vec + o_dwh + h * W, false, wm, cb);
  }
  if (tid < p.hf) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += hb[r * p.hf + tid];
    vec[o_dbh + tid] = s;
  }
  PHASE_MARK(2, kScal);

  // 4. DG: the inner chain, the body's step 4: s_{L-1} = relu'(h) wd,
  // s_{l-1} = relu'(h_{l-1}) (s_l Wa_l), each to the tile and the scratch.
  if constexpr (DG) {
    {
      const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float q = __ldg(p.wd + cb + col_of(j));
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = bit_at(mk, 8 * i + j) ? q : 0.f;
      }
    }
    cons_sync();  // the head sums are done with the tile
    put_tile<kLD>(act, acc, rb, cb);
    cons_sync();
    put_rows<W>(rows_at(p.ss, p.depth - 1), acc, rb, cb);
    PHASE_MARK(3, kScal);
    for (int l = p.depth - 1; l > 0; --l) {
      product<W>(acc, act, W, act, W, ring, ringp, rb, cb);
      PHASE_MARK(3, kProd);
      cons_sync();
      const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (!bit_at(mk, 8 * i + j)) acc[i][j] = 0.f;
      put_tile<kLD>(act, acc, rb, cb);
      cons_sync();
      put_rows<W>(rows_at(p.ss, l - 1), acc, rb, cb);
      PHASE_MARK(3, kScal);
    }
  }

  // 5. The head backward: g = sbar wd + hbar wh^T, in the body's order;
  // with the compute-dtype head g = cbar wc^T + g32, as the body's step 5.
  // zeta_{L-1} = relu'(h) g, and db_{L-1} its column sums.
  {
    float g3[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) g3[i][j] = 0.f;
    for (int h = 0; h < p.hf; ++h) {
      float hv[8], wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) hv[i] = hb[(rb + row_of(i)) * p.hf + h];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = __ldg(p.wh + h * W + cb + col_of(j));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g3[i][j] = fmaf(hv[i], wv[j], g3[i][j]);
    }
    if (p.wd != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wv = __ldg(p.wd + cb + col_of(j));
#pragma unroll
        for (int i = 0; i < 8; ++i) g3[i][j] = sb[rb + row_of(i)] * wv + g3[i][j];
      }
    }
    if constexpr (HC > 0) {
      // cbar, k-major into the activation tile's rows [0, HC), and to the
      // scratch; dbc its column sums; acc = cbar wc^T.
      cons_sync();  // every reader of the tile (the inner chain) is done
      const float* cbar = static_cast<const float*>(p.cbar);
      float* cs_g = static_cast<float*>(p.cs) + row0 * static_cast<size_t>(HC);
      for (int i = tid; i < kRows * HC; i += kCons) {
        const int r = i / HC, c = i % HC;
        const float v = (cbar != nullptr && row0 + r < p.n)
                            ? __ldg(cbar + static_cast<size_t>(row0 + r) * HC + c) : 0.f;
        act[c * kLD + r] = v;
        cs_g[i] = v;
      }
      cons_sync();
      PHASE_MARK(4, kStore);
      if (tid < HC) {
        float s = 0.f;
        for (int r = 0; r < kRows; ++r) s += act[tid * kLD + r];
        vec[o_dbc + tid] = s;
      }
      product(acc, act, HC, act, HC, ring, ringp, rb, cb);
      PHASE_MARK(4, kProd);
      cons_sync();
      const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = bit_at(mk, 8 * i + j) ? acc[i][j] + g3[i][j] : 0.f;
    } else {
      const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = bit_at(mk, 8 * i + j) ? g3[i][j] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cs[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) cs[j] += acc[i][j];
  }
  cons_sync();  // the head sums are done with the tile
  put_tile<kLD>(act, acc, rb, cb);
  PHASE_MARK(4, kScal);
  put_rows<W>(rows_at(p.zs, p.depth - 1), acc, rb, cb);
  PHASE_MARK(4, kStore);
  col_sums<W>(cs, red, vec + (p.depth - 1) * W, false, wm, cb);
  PHASE_MARK(4, kScal);

  // 6. The first-order reverse: zeta_{l-1} = relu'(h_{l-1}) (zeta_l Wa_l),
  // db_{l-1}.
  for (int l = p.depth - 1; l > 0; --l) {
    product<W>(acc, act, W, act, W, ring, ringp, rb, cb);
    PHASE_MARK(5, kProd);
    cons_sync();
    const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cs[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!bit_at(mk, 8 * i + j)) acc[i][j] = 0.f;
        cs[j] += acc[i][j];
      }
    }
    put_tile<kLD>(act, acc, rb, cb);
    PHASE_MARK(5, kScal);
    put_rows<W>(rows_at(p.zs, l - 1), acc, rb, cb);
    PHASE_MARK(5, kStore);
    col_sums<W>(cs, red, vec + (l - 1) * W, false, wm, cb);
    PHASE_MARK(5, kScal);
  }

  // 7. DG: the tangent chain, the body's step 7: p_l = relu'(h_l)
  // ([p_{l-1} | ts] W_l), to the scratch but the last, whose column sums
  // add to dwd; ts made chunk by chunk in the chunk tile (at layer 0 also to
  // the ts scratch), then again at the skip layer.
  if constexpr (DG) {
    float* tsg = static_cast<float*>(p.ts) + row0 * static_cast<size_t>(kin);
    auto ts_share = [&](bool keep) {
      for (int c0 = 0; c0 < kin; c0 += kChunk) {
        const int kc = min(kChunk, kin - c0);
        cons_sync();  // every consumer is done with the last chunk
        ts_chunk(chunk, p, ub, fs, c0, kc, row0);
        cons_sync();
        PHASE_MARK(6, kScal);
        if (keep) {
          const int q4 = kc / 4;
          for (int i = tid; i < kRows * q4; i += kCons) {
            const int r = i / q4, c = 4 * (i % q4);
            *reinterpret_cast<float4*>(tsg + static_cast<size_t>(r) * kin + c0 + c) =
                make_float4(chunk[c * kLD + r], chunk[(c + 1) * kLD + r],
                            chunk[(c + 2) * kLD + r], chunk[(c + 3) * kLD + r]);
          }
          PHASE_MARK(6, kStore);
        }
        product_add(acc, chunk, kc, ring, ringp, rb, cb);
        PHASE_MARK(6, kProd);
      }
    };
    for (int l = 0; l < p.depth; ++l) {
      if (l == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      } else {
        product<W>(acc, act, W, act, W, ring, ringp, rb, cb);
        PHASE_MARK(6, kProd);
      }
      if (l == 0 || l == p.skip) ts_share(l == 0);
      cons_sync();
      const uint2 mk = masks[l * kCons + tid];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cs[j] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!bit_at(mk, 8 * i + j)) acc[i][j] = 0.f;
          cs[j] += acc[i][j];
        }
      }
      if (l + 1 < p.depth) {
        put_tile<kLD>(act, acc, rb, cb);
        cons_sync();
        PHASE_MARK(6, kScal);
        put_rows<W>(rows_at(p.ps, l), acc, rb, cb);
        PHASE_MARK(6, kStore);
      } else {
        col_sums<W>(cs, red, vec + o_dwd, true, wm, cb);
        PHASE_MARK(6, kScal);
      }
    }
  }
}

// W: the trunk width, 256, or 128 for the plain directional trunk alone (HC
// 0, no fused stage, no K11, no cotangent of u). A CTA holds R = 64 (256)
// or 128 (128: two tiles) samples.
// WIDE: the wide-input instance (`bwd_f32_wide`), DG there with the
// cotangent of u.
template <int HC, bool DIR, bool SPA, bool YO, int W = kW, bool WIDE = false, bool DG = false>
__global__ void __launch_bounds__(kTmaThreads, 1)
    trunk_bwd_f32_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ MapsF32 m) {
  static_assert(W == kW || (HC == 0 && !DIR && !SPA && !YO), "width 128: the plain K5 alone");
  static_assert(!WIDE || (W == kW && (HC == 0 || HC == 128 || HC == 256) && !DIR && !SPA && !YO),
                "wide: the heads, the cotangent of u");
  static_assert(WIDE || !DG, "DG: the wide-input instance's");
  constexpr int R = kRowsW<W>, LD = kLDW<W>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if constexpr (WIDE) {
    bwd_f32_wide<HC, DG>(p, m, smem);
    return;
  }
  const int kin = p.kin;
  float* ringp = reinterpret_cast<float*>(smem);                // stages x [16][W]
  float* act = ringp + m.stages * (kSD * W);                    // [W][LD]: h, s, zeta, p
  float* inb = act + W * LD;                                    // [kin][LD]: x, then ts
  uint2* masks = reinterpret_cast<uint2*>(inb + kin * LD);      // [depth][256]
  float* red = reinterpret_cast<float*>(masks + p.depth * kCons);  // [R / 32][W]
  float* sb = red + 2 * kW;                                     // [R]
  float* hb = sb + R;                                           // [R][hf]
  float* ub = hb + R * p.hf;                                    // [R][nb]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(ub + R * p.nb) + 7) & ~static_cast<uintptr_t>(7));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring ring{smem_u32(ringp), smem_u32(bars), smem_u32(bars + m.stages), m.stages, 0, 0u};

  if (tid == 0) {
    for (int s = 0; s < m.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kCons / 32) {  // the producer warp: weight slices, in order
    if (lane == 0) {
      schedule<HC, W>(p, m, [&](const CUtensorMap* map, int col, int K) {
        for (int k = 0; k < K; k += kSD) {
          mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
          mbar_expect_tx(ring.full + 8 * ring.stage, kSliceFW<W>);
          tma_load(ring.base + ring.stage * kSliceFW<W>, map, ring.full + 8 * ring.stage, col, k);
          ring.advance();
        }
      });
    }
    return;
  }

  // The consumers: at width 256 two 32-row halves x four 64-column
  // quarters, at 128 four 32-row quarters x two 64-column halves.
  PHASE_START;
  const int wm = warp >> (W == kW ? 2 : 1);                 // 32-row part of the CTA
  const int rb = 32 * wm + 4 * (lane >> 3);                 // the block's rows rb + R(i)
  const int cb = 64 * (warp & (W / 64 - 1)) + 4 * (lane & 7);  // and columns cb + C(j)
  const int row0 = blockIdx.x * R;
  const size_t rp = static_cast<size_t>(p.rp);
  const bool dg = p.ubar != nullptr;
  const float* bias = static_cast<const float*>(p.b);
  float* vec = p.vec + static_cast<size_t>(blockIdx.x) * p.nvec;
  const int o_dwd = p.depth * W;
  const int o_dwh = o_dwd + (p.wd != nullptr ? W : 0);
  const int o_dbh = o_dwh + p.hf * W;
  const int o_dbc = o_dbh + p.hf;
  [[maybe_unused]] const int o_dbsig = o_dbc + HC;
  // Each region's rows of this CTA: layer l of a [depth][rp][W] region.
  auto rows_at = [&](void* region, int l) {
    return static_cast<float*>(region) + (l * rp + row0) * W;
  };
  float acc[8][8];
  float cs[8];

  // 1. The segments (K8 the IDE block, K7 the IPE) and the cotangents; x to
  // the scratch.
  if constexpr (SPA) {
    if (p.ipe.lm != nullptr)
      load_ipe_f32(inb, stage_ipe(p.ipe, red, row0, p.n), p.d0, kin, row0, p.n);
    else
      load_input_f32<false>(inb, static_cast<const float*>(p.x0), p.d0,
                            static_cast<const float*>(p.x1), p.d1, kin, row0, p.n, p.dir);
  } else if constexpr (W == kW) {
    load_input_f32<DIR>(inb, static_cast<const float*>(p.x0), p.d0,
                        static_cast<const float*>(p.x1), p.d1, kin, row0, p.n, p.dir);
  } else {
    load_input_rows<R>(inb, static_cast<const float*>(p.x0), p.d0,
                       static_cast<const float*>(p.x1), p.d1, kin, row0, p.n);
  }
  for (int r = tid; r < R; r += kCons)
    sb[r] = (p.sbar != nullptr && row0 + r < p.n) ? p.sbar[row0 + r] : 0.f;
  for (int i = tid; i < R * p.hf; i += kCons)
    hb[i] = (p.hbar != nullptr && row0 + i / p.hf < p.n)
                ? p.hbar[static_cast<size_t>(row0) * p.hf + i] : 0.f;
  if (dg)
    for (int i = tid; i < R * p.nb; i += kCons)
      ub[i] = row0 + i / p.nb < p.n ? p.ubar[static_cast<size_t>(row0) * p.nb + i] : 0.f;
  cons_sync();
  PHASE_MARK(0, kScal);
  store_in<W>(static_cast<float*>(p.xs) + row0 * static_cast<size_t>(kin), inb, kin);
  PHASE_MARK(0, kStore);

  // 1b. K6: sbar += ct_raw of this tile's rows, and d bsig (trunk_bwd.cu).
  if constexpr (SPA) {
    if (p.wbar != nullptr) {
      const int S = p.samples, hi = min(row0 + kRows, p.n);
      float* ct = act;                    // [kRows]
      float* tr = ct + kRows + warp * S;  // [S] a warp
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

  // 2. Recompute: h_l = relu(acc + b_l) to the tile and the scratch, relu'
  // masks as bits in the block's order. acc keeps y after the last layer.
  for (int l = 0; l < p.depth; ++l) {
    if (l == 0)
      product<W>(acc, inb, kin, inb, kin, ring, ringp, rb, cb);
    else
      product<W>(acc, act, W, inb, k_dim<W>(p, l), ring, ringp, rb, cb);
    PHASE_MARK(1, kProd);
    cons_sync();
    uint2 mk = make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = __ldg(bias + l * W + cb + col_of(j));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = fmaxf(acc[i][j] + b, 0.f);
        const uint32_t bit = (acc[i][j] > 0.f ? 1u : 0u) << ((8 * i + j) & 31);
        if (i < 4) mk.x |= bit; else mk.y |= bit;
      }
    }
    masks[l * kCons + tid] = mk;
    put_tile<LD>(act, acc, rb, cb);
    cons_sync();
    PHASE_MARK(1, kScal);
    put_rows<W>(rows_at(p.hs, l), acc, rb, cb);
    PHASE_MARK(1, kStore);
  }

  // 2b. K10: the head recomputed on y, the final rgb's cotangent pulled back
  // through the colour epilogue onto the head's.
  if constexpr (DIR) {
    if (p.rgb_bar != nullptr) {
      float whr[3][kW / 32];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < kW / 32; ++i) whr[j][i] = __ldg(p.wh + j * kW + lane + 32 * i);
      float* hv = red;  // [kRows][3]
      for (int r = warp; r < kRows; r += kCons / 32) {
        if (row0 + r >= p.n) break;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kW / 32; ++i) s = fmaf(act[(lane + 32 * i) * kLD + r], whr[j][i], s);
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

  // 3. The head gradients that read y (acc): dwd, dwh by the epilogue's
  // column sums; dbh.
  if (p.wd != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cs[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) cs[j] = fmaf(sb[rb + row_of(i)], acc[i][j], cs[j]);
    }
    col_sums<W>(cs, red, vec + o_dwd, false, wm, cb);
  }
  for (int h = 0; h < p.hf; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cs[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) cs[j] = fmaf(hb[(rb + row_of(i)) * p.hf + h], acc[i][j], cs[j]);
    }
    col_sums<W>(cs, red, vec + o_dwh + h * W, false, wm, cb);
  }
  if (tid < p.hf) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += hb[r * p.hf + tid];
    vec[o_dbh + tid] = s;
  }
  PHASE_MARK(2, kScal);

  // 4. With u's cotangent, the inner chain: s_{L-1} = relu'(h) wd,
  // s_{l-1} = relu'(h_{l-1}) (s_l Wa_l), each to the tile and the scratch.
  if constexpr (W == kW) {  // no cotangent of u at width 128
    if (dg) {
      {
        const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float q = __ldg(p.wd + cb + col_of(j));
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = bit_at(mk, 8 * i + j) ? q : 0.f;
        }
      }
      cons_sync();  // K10 and the head sums are done with the tile
      put_tile<LD>(act, acc, rb, cb);
      cons_sync();
      put_rows<W>(rows_at(p.ss, p.depth - 1), acc, rb, cb);
      PHASE_MARK(3, kScal);
      for (int l = p.depth - 1; l > 0; --l) {
        product<W>(acc, act, W, act, W, ring, ringp, rb, cb);
        PHASE_MARK(3, kProd);
        cons_sync();
        const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!bit_at(mk, 8 * i + j)) acc[i][j] = 0.f;
        put_tile<LD>(act, acc, rb, cb);
        cons_sync();
        put_rows<W>(rows_at(p.ss, l - 1), acc, rb, cb);
        PHASE_MARK(3, kScal);
      }
    }
  }

  // 5. The head backward: g = cbar wc^T + g32, g32 = sbar wd + hbar wh^T;
  // with K11 g = ybar + g32. zeta_{L-1} = relu'(h) g, and db_{L-1} its
  // column sums. g32 of the block head by head, in trunk_bwd.cu's order.
  float g3[8][8];
  {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) g3[i][j] = 0.f;
    for (int h = 0; h < p.hf; ++h) {
      float hv[8], wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) hv[i] = hb[(rb + row_of(i)) * p.hf + h];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = __ldg(p.wh + h * W + cb + col_of(j));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g3[i][j] = fmaf(hv[i], wv[j], g3[i][j]);
    }
    if (p.wd != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wv = __ldg(p.wd + cb + col_of(j));
#pragma unroll
        for (int i = 0; i < 8; ++i) g3[i][j] = sb[rb + row_of(i)] * wv + g3[i][j];
      }
    }
  }
  cons_sync();  // every reader of the tile (K10, the inner chain) is done
  if constexpr (HC > 0) {
    // cbar, k-major into the activation tile's rows [0, HC), and to the
    // scratch; dbc its column sums.
    const float* cbar = static_cast<const float*>(p.cbar);
    float* cs_g = static_cast<float*>(p.cs) + row0 * static_cast<size_t>(HC);
    for (int i = tid; i < kRows * HC; i += kCons) {
      const int r = i / HC, c = i % HC;
      const float v = (cbar != nullptr && row0 + r < p.n)
                          ? __ldg(cbar + static_cast<size_t>(row0 + r) * HC + c) : 0.f;
      act[c * kLD + r] = v;
      cs_g[i] = v;
    }
    cons_sync();
    PHASE_MARK(4, kStore);
    if (tid < HC) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += act[tid * kLD + r];
      vec[o_dbc + tid] = s;
    }
    product(acc, act, HC, act, HC, ring, ringp, rb, cb);
    PHASE_MARK(4, kProd);
    cons_sync();
  }
  {
    const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rb + row_of(i);
      float yb[8];
      if constexpr (YO) {
        const float* ybar = static_cast<const float*>(p.ybar) +
                            static_cast<size_t>(row0 + r) * kW + cb;
        const bool live = row0 + r < p.n;
        const float4 y0 = live ? *reinterpret_cast<const float4*>(ybar) : make_float4(0, 0, 0, 0);
        const float4 y1 =
            live ? *reinterpret_cast<const float4*>(ybar + 32) : make_float4(0, 0, 0, 0);
        yb[0] = y0.x, yb[1] = y0.y, yb[2] = y0.z, yb[3] = y0.w;
        yb[4] = y1.x, yb[5] = y1.y, yb[6] = y1.z, yb[7] = y1.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float gv;
        if constexpr (HC > 0)
          gv = acc[i][j] + g3[i][j];
        else if constexpr (YO)
          gv = yb[j] + g3[i][j];
        else
          gv = g3[i][j];
        acc[i][j] = bit_at(mk, 8 * i + j) ? gv : 0.f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cs[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) cs[j] += acc[i][j];
  }
  put_tile<LD>(act, acc, rb, cb);
  PHASE_MARK(4, kScal);
  put_rows<W>(rows_at(p.zs, p.depth - 1), acc, rb, cb);
  PHASE_MARK(4, kStore);
  col_sums<W>(cs, red, vec + (p.depth - 1) * W, false, wm, cb);
  PHASE_MARK(4, kScal);

  // 6. The first-order reverse: dx, zeta_{l-1} = relu'(h_{l-1}) (zeta_l
  // Wa_l), db_{l-1}.
  [[maybe_unused]] float* dsh = inb;  // K8: [kRows][dide]
  for (int l = p.depth - 1; l >= 0; --l) {
    if constexpr (W != kW) {
      if (p.dx0 != nullptr && (l == 0 || l == p.skip)) {
        // Width 128: dx (no IDE block here) in passes over the kin input
        // columns, 128 at a time, each as the width-256 block below; a last
        // pass over at most 64 columns runs `product_half`, its 4 columns
        // cbh + j a thread in acc[i][0..3] (one group, h = 0).
        const int cbh = 32 * (warp & 1) + 4 * (lane & 7);
        for (int cx = 0; cx < kin; cx += W) {
          const bool half = kin - cx <= W / 2;
          if (half) {
            Half hv;
            product_half<W>(hv, act, W, ring, ringp, rb, cbh);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = hv[i][j];
          } else {
            product<W>(acc, act, W, act, W, ring, ringp, rb, cb);
          }
          PHASE_MARK(5, kProd);
          const int base = half ? cx + cbh : cx + cb;  // group h at base + 32 h
          if (l == 0 && p.skip >= 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c0 = base + 32 * h;
                if (c0 >= kin || (half && h == 1)) continue;
                const float4 k4 = *reinterpret_cast<const float4*>(
                    p.dxs + static_cast<size_t>(row0 + rb + row_of(i)) * kin + c0);
                acc[i][4 * h] = k4.x + acc[i][4 * h];
                acc[i][4 * h + 1] = k4.y + acc[i][4 * h + 1];
                acc[i][4 * h + 2] = k4.z + acc[i][4 * h + 2];
                acc[i][4 * h + 3] = k4.w + acc[i][4 * h + 3];
              }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = rb + row_of(i);
            const size_t gr = static_cast<size_t>(row0 + r);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c0 = base + 32 * h;
              if (c0 >= kin || (half && h == 1)) continue;
              const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                  acc[i][4 * h + 3]};
              if (l != 0) {
                *reinterpret_cast<float4*>(p.dxs + gr * kin + c0) =
                    make_float4(v[0], v[1], v[2], v[3]);
              } else if (c0 + 3 < p.d0 && (p.d0 & 3) == 0) {
                if (row0 + r < p.n)
                  *reinterpret_cast<float4*>(static_cast<float*>(p.dx0) + gr * p.d0 + c0) =
                      make_float4(v[0], v[1], v[2], v[3]);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int c = c0 + e;
                  if (row0 + r >= p.n || c >= p.d0 + p.d1) continue;
                  if (c < p.d0)
                    static_cast<float*>(p.dx0)[gr * p.d0 + c] = v[e];
                  else
                    static_cast<float*>(p.dx1)[gr * p.d1 + (c - p.d0)] = v[e];
                }
              }
            }
          }
          PHASE_MARK(5, kStore);
        }
      }
    } else {
      if (HC == 0 && p.dx0 != nullptr && (l == 0 || l == p.skip)) {
        // dx = (0 + zeta_skip Wx_skip) + zeta_0 Wx_0 in f32, the skip layer's
        // share in the f32 scratch; with K8 the IDE block's cotangents to dsh.
        product(acc, act, kW, act, kW, ring, ringp, rb, cb);
        PHASE_MARK(5, kProd);
        const int dide = DIR ? p.dir.width() : 0, fin = p.d0 + dide + p.d1;
        if (l == 0 && p.skip >= 0) {
          // The skip layer's share first, every load in flight before a store.
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c0 = cb + 32 * h;
              if (c0 >= kin) continue;
              const float4 k4 = *reinterpret_cast<const float4*>(
                  p.dxs + static_cast<size_t>(row0 + rb + row_of(i)) * kin + c0);
              acc[i][4 * h] = k4.x + acc[i][4 * h];
              acc[i][4 * h + 1] = k4.y + acc[i][4 * h + 1];
              acc[i][4 * h + 2] = k4.z + acc[i][4 * h + 2];
              acc[i][4 * h + 3] = k4.w + acc[i][4 * h + 3];
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rb + row_of(i);
          const size_t gr = static_cast<size_t>(row0 + r);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c0 = cb + 32 * h;
            if (c0 >= kin) continue;
            const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                acc[i][4 * h + 3]};
            if (l != 0) {
              *reinterpret_cast<float4*>(p.dxs + gr * kin + c0) =
                  make_float4(v[0], v[1], v[2], v[3]);
              continue;
            }
            if (c0 + 3 < p.d0 && (p.d0 & 3) == 0) {  // four columns of dx0: one store
              if (row0 + r < p.n)
                *reinterpret_cast<float4*>(static_cast<float*>(p.dx0) + gr * p.d0 + c0) =
                    make_float4(v[0], v[1], v[2], v[3]);
              continue;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = c0 + e, ci = c - p.d0;
              if (DIR && ci >= 0 && ci < dide) {
                dsh[r * dide + ci] = v[e];
                continue;
              }
              if (row0 + r >= p.n || c >= fin) continue;
              if (c < p.d0)
                static_cast<float*>(p.dx0)[gr * p.d0 + c] = v[e];
              else
                static_cast<float*>(p.dx1)[gr * p.d1 + (ci - dide)] = v[e];
            }
          }
        }
        PHASE_MARK(5, kStore);
      }
    }
    if (l > 0) {
      product<W>(acc, act, W, act, W, ring, ringp, rb, cb);
      PHASE_MARK(5, kProd);
      cons_sync();
      const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cs[j] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!bit_at(mk, 8 * i + j)) acc[i][j] = 0.f;
          cs[j] += acc[i][j];
        }
      }
      put_tile<LD>(act, acc, rb, cb);
      PHASE_MARK(5, kScal);
      put_rows<W>(rows_at(p.zs, l - 1), acc, rb, cb);
      PHASE_MARK(5, kStore);
      col_sums<W>(cs, red, vec + (l - 1) * W, false, wm, cb);
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

  // 7. With u's cotangent, the tangent chain: ts = (t xc, -(t xs)) replaces
  // x in the input tile; p_l = relu'(h_l) ([p_{l-1} | ts] W_l), to the
  // scratch but the last, whose column sums add to dwd.
  if constexpr (W == kW) {  // no cotangent of u at width 128
    if (dg) {
      const int F = p.d0;
      [[maybe_unused]] Ipe ipe_s;
      if constexpr (SPA) {
        if (p.ipe.lm != nullptr) ipe_s = stage_ipe(p.ipe, red, row0, p.n);
      }
      for (int i = tid; i < R * F; i += kCons) {
        const int r = i / F, c = i % F;
        float tp = 0.f;
        for (int j = 0; j < p.nb; ++j) tp = fmaf(ub[r * p.nb + j], p.fold[c * p.nb + j], tp);
        if constexpr (SPA) {
          if (p.ipe.lm != nullptr) {  // K7: the f32 factors
            float e = 0.f, sn = 0.f, cs_ = 0.f;
            if (row0 + r < p.n) ipe_trig(ipe_s, r, c, e, sn, cs_);
            const float te = mul(tp, e);
            inb[c * LD + r] = mul(te, cs_);
            inb[(F + c) * LD + r] = -mul(te, sn);
            continue;
          }
        }
        const float xs = inb[c * LD + r], xc = inb[(F + c) * LD + r];
        inb[c * LD + r] = tp * xc;
        inb[(F + c) * LD + r] = -(tp * xs);
      }
      cons_sync();
      PHASE_MARK(6, kScal);
      store_in<W>(static_cast<float*>(p.ts) + row0 * static_cast<size_t>(kin), inb, kin);
      PHASE_MARK(6, kStore);
      for (int l = 0; l < p.depth; ++l) {
        if (l == 0)
          product<W>(acc, inb, kin, inb, kin, ring, ringp, rb, cb);
        else
          product<W>(acc, act, W, inb, k_dim<W>(p, l), ring, ringp, rb, cb);
        PHASE_MARK(6, kProd);
        cons_sync();
        const uint2 mk = masks[l * kCons + tid];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          cs[j] = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (!bit_at(mk, 8 * i + j)) acc[i][j] = 0.f;
            cs[j] += acc[i][j];
          }
        }
        if (l + 1 < p.depth) {
          put_tile<LD>(act, acc, rb, cb);
          cons_sync();
          PHASE_MARK(6, kScal);
          put_rows<W>(rows_at(p.ps, l), acc, rb, cb);
          PHASE_MARK(6, kStore);
        } else {
          col_sums<W>(cs, red, vec + o_dwd, true, wm, cb);
          PHASE_MARK(6, kScal);
        }
      }
    }
  }
}

// Shared memory of the per-CTA kernel but its ring, and the ring's stages
// that fit beside it (0 when fewer than kMinStages do), at width W.
template <int W>
size_t f32_smem(const BwdParams& p, int* stages) {
  const size_t rest = 1024 + 4 * static_cast<size_t>(W + p.kin) * kLDW<W> +
                      8 * static_cast<size_t>(p.depth) * kCons + 4 * 2 * kW +
                      4 * static_cast<size_t>(kRowsW<W>) * (1 + p.hf + p.nb) + 8 +
                      16 * kMaxStages;
  const size_t fit = rest < 232448 ? (232448 - rest) / kSliceFW<W> : 0;
  *stages = fit < kMinStages ? 0 : static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return rest + static_cast<size_t>(*stages) * kSliceFW<W>;
}

// Shared memory of a launch of the wide-input instance, and the ring's
// stages that fit (ubar's rows and the fold with the cotangent of u);
// fused_mlp.py `kernel_smem` mirrors this sum.
size_t f32_wide_smem(const BwdParams& p, int* stages) {
  const size_t rest = 1024 + 4 * static_cast<size_t>(kW + kChunk) * kLD +
                      8 * static_cast<size_t>(p.depth) * kCons + 4 * 2 * kW +
                      4 * static_cast<size_t>(kRows) * (1 + p.hf + (p.ubar ? p.nb : 0)) +
                      (p.ubar ? 4 * static_cast<size_t>(p.d0) * p.nb : 0) + 8 + 16 * kMaxStages;
  const size_t fit = rest < 232448 ? (232448 - rest) / kSliceF : 0;
  *stages = fit < kMinStages ? 0 : static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return rest + static_cast<size_t>(*stages) * kSliceF;
}

template <int HC, bool DIR, bool SPA, bool YO, int W = kW, bool WIDE = false, bool DG = false>
int launch_f32(const BwdParams& p, int hc, cudaStream_t stream) {
  if (p.depth > kMaxDepth || p.kin > (WIDE ? kWideKin : kW) || hc != HC ||
      p.rp % kRowsW<W> != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The wide-input instance runs no dx, and the cotangent of u in DG alone.
  if (WIDE && (p.dx0 != nullptr || (p.ubar != nullptr) != DG))
    return static_cast<int>(cudaErrorInvalidValue);
  // K6's scratch ([kRows] + [8 warps][S] floats) and K8's f32 cotangents
  // must fit in the activation and input tiles, K7's staged inputs in red.
  if (SPA && p.wbar != nullptr && kRows + (kCons / 32) * p.samples > kW * kLD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (DIR && p.dir.p && kRows * p.dir.width() > p.kin * kLD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (SPA && p.ipe.lm != nullptr && kRows * p.ipe.nb > kW)
    return static_cast<int>(cudaErrorInvalidValue);
  // dx only in the instances without a compute-dtype head (the directional
  // trunk's K5).
  if (HC > 0 && p.dx0 != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  MapsF32 m;
  memset(&m, 0, sizeof(m));
  bool ok = make_layer_maps_f32<W>(m, p.w, p.wt, p.depth, p.kin, p.skip);
  if (HC > 0) ok = ok && make_map_f32(&m.wc, p.wct, kW, HC, kW, kW, kSD);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = WIDE ? f32_wide_smem(p, &m.stages) : f32_smem<W>(p, &m.stages);
  if (m.stages == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(trunk_bwd_f32_kernel<HC, DIR, SPA, YO, W, WIDE, DG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_bwd_f32_kernel<HC, DIR, SPA, YO, W, WIDE, DG>
      <<<p.rp / kRowsW<W>, kTmaThreads, smem, stream>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The weight-gradient product: out[split][M][N] = sum over the split's
// samples of Z^T [A | X] (+ S^T [PA | TX]), every operand sample-major
// [rp][features] in device memory. A CTA: a 128 x 128 output tile, the
// per-tile kernel's 8 x 8 blocks (a warp 32 rows x 64 columns), one
// producer warp that loads kWS samples of each operand a stage by TMA.

constexpr int kWS = 32;                    // samples a stage
constexpr int kWBox = kWS * 128 * 4;       // bytes of a [kWS][128] f32 box
constexpr int kWgStagesF = 3;

struct WgradMapsF32 {
  CUtensorMap z, a, x, s, pa, tx;
};

struct WgradF32 {
  int M, N, ncut, rp, ksplit, tiles_m;
  bool two;
  float* out;
};

__global__ void __launch_bounds__(kTmaThreads, 1)
    wgrad_f32_kernel(const __grid_constant__ WgradF32 p, const __grid_constant__ WgradMapsF32 m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr int kStage = 4 * kWBox;  // Z | A | S | PA
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kWgStagesF * kStage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Ring r{smem_u32(smem), smem_u32(bars), smem_u32(bars + kWgStagesF), kWgStagesF, 0, 0u};
  const int m0 = (blockIdx.x % p.tiles_m) * 128, n0 = (blockIdx.x / p.tiles_m) * 128;
  const int kb = blockIdx.y * p.ksplit;
  const int ke = min(kb + p.ksplit, p.rp);
  const int ns = (ke - kb) / kWS;
  if (tid == 0) {
    for (int s = 0; s < kWgStagesF; ++s) {
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
      const uint32_t bytes = (p.two ? 4 : 2) * kWBox;
      for (int s = 0; s < ns; ++s) {
        const int k0 = kb + kWS * s;
        mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
        const uint32_t full = r.full + 8 * r.stage, dst = r.base + r.stage * kStage;
        mbar_expect_tx(full, bytes);
        tma_load(dst, &m.z, full, m0, k0);
        tma_load(dst + kWBox, b1, full, bc, k0);
        if (p.two) {
          tma_load(dst + 2 * kWBox, &m.s, full, m0, k0);
          tma_load(dst + 3 * kWBox, b2, full, bc, k0);
        }
        r.advance();
      }
    }
    return;
  }

  const int rb = 32 * (warp >> 1) + 4 * (lane >> 3);
  const int cb = 64 * (warp & 1) + 4 * (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float* base = reinterpret_cast<const float*>(smem);
  for (int s = 0; s < ns; ++s) {
    const float* st = base + r.stage * (kStage / 4);
    mbar_wait(r.full + 8 * r.stage, r.phase);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !p.two) break;
      const float* za = st + q * (2 * kWBox / 4) + rb;
      const float* xb = st + q * (2 * kWBox / 4) + kWBox / 4 + cb;
#pragma unroll 8
      for (int kk = 0; kk < kWS; ++kk) {
        const float4 a0v = *reinterpret_cast<const float4*>(za + kk * 128);
        const float4 a1v = *reinterpret_cast<const float4*>(za + kk * 128 + 16);
        const float4 b0v = *reinterpret_cast<const float4*>(xb + kk * 128);
        const float4 b1v = *reinterpret_cast<const float4*>(xb + kk * 128 + 32);
        const float av[8] = {a0v.x, a0v.y, a0v.z, a0v.w, a1v.x, a1v.y, a1v.z, a1v.w};
        const float bv[8] = {b0v.x, b0v.y, b0v.z, b0v.w, b1v.x, b1v.y, b1v.z, b1v.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty + 8 * r.stage);
    r.advance();
  }

  float* out = p.out + static_cast<size_t>(blockIdx.y) * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + rb + row_of(i);
    if (row >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + cb + 32 * h;
      if (col < p.N)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * p.N + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

}  // namespace

// Plain C entries for ctypes, as trunk_bwd.cu's: each returns the
// cudaError_t of its launch (0 on success), allocates nothing and does not
// synchronise; all run on `stream`.

// The per-tile backward of refnerf_trunk_bwd (the same arguments), for the
// f32 trunk (dtype 0) of at most 8 layers and 256 input columns: at width
// 256 K4 (hc 128; with K6/K7, SPA), K5 (hc 0, dx; with K8-K10, DIR) and
// K11's y cotangent (YO), dx only with hc 0, as the directional trunk asks
// for it; at width 128 the plain K5 alone (hc 0, no density head, fused
// stage, cotangent of u or y), 128 samples a CTA, so rp a multiple of 128;
// past 256 and up to kWideKin input columns K4 at width 256 with the density
// head, f32 heads and the compute-dtype head (hc 0, 128 or 256), with or
// without the cotangent of u (nb <= kMaxNbWide), no fused stage, y or dx
// (the wide-input instance).
// `wct` is the compute-dtype head untransposed, wc [hc][width] (its
// products read the contraction index outermost). The weight-gradient
// operands go to the scratch sample-major, [rp][features] per region (h,
// zeta, s, p: [depth][rp][W]; x, ts: [rp][kin]; cbar: [rp][hc]), for
// refnerf_wgrad_f32; the vector gradients one row a CTA.
extern "C" int refnerf_trunk_bwd_f32(REFNERF_BWD_ARGS) {
  BwdParams p;
  const int err = bwd_params(p, REFNERF_BWD_NAMES);
  if (err != 0) return err;
  if (dtype != 0 || (width != kW && width != 128)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dir = p.dir.p != 0 || p.rgb_bar != nullptr;
  const bool spa = p.ipe.lm != nullptr || p.wbar != nullptr;
  if (width == 128)
    return hc == 0 && !dir && !spa && p.ubar == nullptr && p.wd == nullptr && p.ybar == nullptr
               ? launch_f32<0, false, false, false, 128>(p, hc, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (p.kin > kW) {  // the wide-input instance: the heads, the cotangent of u, no dx
    if (dir || spa || p.ybar != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (p.ubar != nullptr)
      return hc == 0     ? launch_f32<0, false, false, false, kW, true, true>(p, hc, s)
             : hc == 128 ? launch_f32<128, false, false, false, kW, true, true>(p, hc, s)
             : hc == 256 ? launch_f32<256, false, false, false, kW, true, true>(p, hc, s)
                         : static_cast<int>(cudaErrorInvalidValue);
    return hc == 0     ? launch_f32<0, false, false, false, kW, true>(p, hc, s)
           : hc == 128 ? launch_f32<128, false, false, false, kW, true>(p, hc, s)
           : hc == 256 ? launch_f32<256, false, false, false, kW, true>(p, hc, s)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.ybar != nullptr)
    return hc == 0 && !dir && !spa && p.ubar == nullptr
               ? launch_f32<0, false, false, true>(p, hc, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (hc == 0 && !spa)
    return dir ? launch_f32<0, true, false, false>(p, hc, s)
               : launch_f32<0, false, false, false>(p, hc, s);
  if (hc == 128 && !dir)
    return spa ? launch_f32<128, false, true, false>(p, hc, s)
               : launch_f32<128, false, false, false>(p, hc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Per-split partials out[split][M][N] of dW = Z^T [A | X] (+ S^T [PA | TX])
// over rp samples, as refnerf_wgrad (the same arguments) but every operand
// sample-major: z [rp][M], a [rp][ncut], x [rp][N - ncut], s [rp][M], pa
// [rp][ncut], tx [rp][N - ncut]. f32 (dtype 0) only; M and ncut multiples
// of 128, N of 4, rp and ksplit of 32.
extern "C" int refnerf_wgrad_f32(int dtype, int M, int N, int ncut, int rp, int ksplit,
                                 const void* z, const void* a, const void* x, const void* s,
                                 const void* pa, const void* tx, float* out, void* stream) {
  if (dtype != 0 || M <= 0 || M % 128 != 0 || N <= 0 || N % 4 != 0 || ncut < 0 || ncut > N ||
      ncut % 128 != 0 || rp <= 0 || rp % kWS != 0 || ksplit <= 0 || ksplit % kWS != 0 ||
      z == nullptr || (ncut > 0 && a == nullptr) || (ncut < N && x == nullptr) ||
      (s != nullptr && ((ncut > 0 && pa == nullptr) || (ncut < N && tx == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  WgradMapsF32 m;
  memset(&m, 0, sizeof(m));
  bool ok = make_map_f32(&m.z, z, M, rp, M, 128, kWS);
  if (ncut > 0) ok = ok && make_map_f32(&m.a, a, ncut, rp, ncut, 128, kWS);
  if (ncut < N) ok = ok && make_map_f32(&m.x, x, N - ncut, rp, N - ncut, 128, kWS);
  if (s != nullptr) {
    ok = ok && make_map_f32(&m.s, s, M, rp, M, 128, kWS);
    if (ncut > 0) ok = ok && make_map_f32(&m.pa, pa, ncut, rp, ncut, 128, kWS);
    if (ncut < N) ok = ok && make_map_f32(&m.tx, tx, N - ncut, rp, N - ncut, 128, kWS);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_m = M / 128, tiles_n = (N + 127) / 128;
  const WgradF32 p{M, N, ncut, rp, ksplit, tiles_m, s != nullptr, out};
  const size_t smem = 1024 + static_cast<size_t>(kWgStagesF) * 4 * kWBox + 16 * kWgStagesF;
  cudaError_t err = cudaFuncSetAttribute(wgrad_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_m * tiles_n, (rp + ksplit - 1) / ksplit);
  wgrad_f32_kernel<<<grid, kTmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

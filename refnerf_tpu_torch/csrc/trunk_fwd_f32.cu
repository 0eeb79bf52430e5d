// The f32 trunk forward for Hopper (sm_90a) at widths 256 and 128:
// register-blocked FMA products fed by a TMA weight ring.
//
// Replaces, for the compute dtype float32 (up to 8 layers, 256 input
// columns and 16 f32 heads), the forward Pallas kernel `_fwd_kernel`
// (:612-666) of refnerf_tpu/ops/pallas/fused_mlp.py in the modes of
// trunk_fwd.cu but K11: at width 256 K1 (the spatial trunk and its heads;
// hf = 0 too), K2 (the directional trunk), K3 (K1 with the density
// gradient, `_inner_chain` :589-609 and the fold :651-662), K6 and K7 on
// K1/K3 (the compositing weights `_epilogue_fwd` :498, the IPE `_segments`
// :550-563, `_safe_trig_arg` :191), K8-K10 on K2 (the IDE `_ide_fwd` :402,
// the direction geometry `_dir_geometry` :355, the colour epilogue
// `_rgb_epilogue` :283); at width 128 the plain K2 (mip-NeRF's directional
// trunk, `fwd_f32_rows`). It computes what trunk_fwd.cu computes, with the
// same arithmetic (trunk_fwd.cu:35-47: h_l = relu(acc + b_l); sigma and the
// f32 heads on y; the bottleneck y wc^T + bc; K3's chain s_{l-1} =
// relu'(h_{l-1}) (s_l Wa_l) with u_x summed over the skip layer and layer 0,
// then folded), from the same C arguments but for the head: this library
// reads the compute-dtype head transposed, wc^T [W][HC], through the `wc`
// argument. Every product runs in full f32 on the FMA pipes (no TF32). K11
// and the trunks past these shapes or past this kernel's shared memory
// (`fwd_f32_smem`: K3 on 193-256 input columns) stay in trunk_fwd.cu; past
// 256 input columns the wide-input instance (`fwd_f32_wide`) runs K1 and K3
// with sigma, the f32 heads and a 128- or 256-wide bottleneck.
//
// Bound on the H100: K1 needs ~1.09 MFLOP a sample, K3 ~2.10, K2 at width
// 128 ~0.31 (0.57 / 1.10 / 0.16 TFLOP at N = 524,288, chip_smoke.py
// `trunk_flops`; 8.5 / 16.5 / 2.4 ms at 67 TFLOP/s); device memory carries
// the inputs and outputs (~0.1-0.4 GB, about 0.1 ms). A 64-row tile reads
// each layer's f32 weights (256 KB) from L2 for 8.4 MFLOP, 32 FLOP a byte:
// ~2.1 TB/s at the FMA peak, within L2's reach, so one tile at a time at
// width 256; at 128 a tile's product over a slice is half as large while
// each slice still costs a wait and an arrive, so a CTA takes two tiles.
//
// Design (trunk_bwd_f32.cu's forward half; the shared blocks are in
// trunk_f32.cuh).
//  - Two consumer warpgroups and one producer warp own a 64-sample tile.
//    Each thread owns an 8 x 8 block of every product's outputs and reads
//    its operands as four LDS.128 a k step for 64 FFMA (`product`).
//  - The activation and input tiles are k-major, [feature][kLD]; each
//    epilogue writes its block feature-major for the next product.
//  - The weights come by TMA in 16-deep slices of 256 columns through a
//    ring of as many stages as shared memory holds (2 to 8), with
//    full/empty mbarriers. The producer walks the tile's `schedule` (the
//    layers on `wt`, the bottleneck on wc^T, K3's chain on `w`), so no CTA
//    barrier paces a slice and the next product's weights load during an
//    epilogue.
//  - The epilogues work in registers: the bias, the ReLU and K3's relu'
//    bits (64 a thread and layer, in the block's own order); sigma and the
//    f32 heads as partial dot products over the thread's 8 columns, summed
//    over the 8 lanes that share its rows by a butterfly and then over the
//    4 column warps in a fixed order (no atomics: reruns are bit-identical);
//    the bottleneck as one more product on wc^T, stored from its
//    accumulators; K3's masks applied in the chain's epilogues, and u_x
//    accumulated over the skip layer and layer 0 in a k-major f32 tile,
//    then folded. The products at most 128 columns wide (the bottleneck,
//    u_x on at most 128 input columns) run on a block of 8 x 4, half the
//    work of multiplying the zero columns past the weights' extent.
//  - K7's lifted means and variances are staged before use (`stage_ipe`)
//    and the IPE made in the input tile; K8 and K9 make the IDE block in
//    the input tile (`load_input_f32<true>`); K10 runs after the rgb head.
//    With K6 a CTA owns lcm(S, 64) rows (whole rays), keeps the raw
//    densities in shared memory and runs `ray_weights` one warp a ray.
// One CTA an SM (~100-230 KB of shared memory).

#define PHASE_SYNC() cons_sync()  // closes a stamped segment
#include "trunk_f32.cuh"
#include "trunk_fwd_args.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kMinStages = 2;
constexpr int kMaxHeads = 16;           // f32 heads (hf), the density head besides
constexpr int kHG = 4;                  // heads summed a pass
constexpr int kRed = kHG * 4 * kRows;   // floats of red: [kHG][4 column warps][kRows]

template <int W = kW>
__device__ __forceinline__ int k_dim(const FwdParams& p, int l) {
  return l == 0 ? p.kin : (l == p.skip ? W + p.kin : W);
}

// The products of one tile in order, as (tensor map, first column, K rows);
// the producer loads their slices, and the kernel below runs them in this
// order.
template <int HC, typename F>
__device__ void schedule(const FwdParams& p, const MapsF32& m, F&& load) {
  for (int l = 0; l < p.depth; ++l) load(&m.wt[l], 0, k_dim(p, l));  // the layers
  if (HC > 0) load(&m.wc, 0, kW);                                    // the bottleneck
  if (p.u != nullptr) {                                              // K3's chain
    for (int l = p.depth - 1; l > 0; --l) {
      if (l == p.skip) load(&m.w[l], kW, kW);  // u_x of the skip layer
      load(&m.w[l], 0, kW);                    // s_{l-1}
    }
    load(&m.w[0], 0, kW);  // u_x of layer 0
  }
}

// The sum over the 8 lanes that share a block's rows (lane / 8 alike) of
// each of v[0..7]: a butterfly that leaves lane q (lane % 8) with the sum of
// v[q], 7 shuffles.
__device__ __forceinline__ float row_sums(const float (&v)[8]) {
  const int q = threadIdx.x & 7;
  const bool b2 = q & 4, b1 = q & 2, b0 = q & 1;
  float w[4], x[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (b2 ? v[k + 4] : v[k]) + __shfl_xor_sync(0xffffffffu, b2 ? v[k] : v[k + 4], 4);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    x[k] = (b1 ? w[k + 2] : w[k]) + __shfl_xor_sync(0xffffffffu, b1 ? w[k] : w[k + 2], 2);
  return (b0 ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, b0 ? x[0] : x[1], 1);
}

// K3's u_x: the block's columns (cb + C(j), or with a half-width block cbh
// + j) below kin into the k-major [kin][kLD] tile ux, 0 + acc at the first
// of its products (as trunk_fwd.cu sums from 0), else added to what is
// there. Each thread reads and writes only its own block.
template <int NC>
__device__ __forceinline__ void put_ux(float* ux, const float (&v)[8][NC], int kin, bool first,
                                       int rb, int cb) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = NC == 8 ? cb + col_of(j) : cb + j;
    if (c >= kin) continue;
    float4* d = reinterpret_cast<float4*>(ux + c * kLD + rb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : d[4 * h];
      d[4 * h] = make_float4(o.x + v[4 * h][j], o.y + v[4 * h + 1][j], o.z + v[4 * h + 2][j],
                             o.w + v[4 * h + 3][j]);
    }
  }
}

// Width 128: mip-NeRF's plain directional trunk (K2 at width 128: the f32
// heads, no density head, bottleneck, fused stage or y). A CTA takes R = 128
// samples, two tiles as one k-major [feature][kLDW<128>] tile, as
// trunk_bwd_f32.cu's width-128 recompute: its 8 consumer warps are 4 row
// quarters x 2 column halves, each thread an 8 x 8 block with 4 LDS.128 a k
// step, fed by [16][128] slices (8 KB) that serve all 128 samples. The f32
// heads' partial dot products are summed over a row's 8 lanes by
// `row_sums`, then over the 2 column warps in order.
template <int W>
__device__ __forceinline__ void fwd_f32_rows(const FwdParams& p, const MapsF32& m,
                                             unsigned char* smem) {
  constexpr int R = kRowsW<W>, LD = kLDW<W>;
  const int kin = p.kin;
  float* ringp = reinterpret_cast<float*>(smem);  // stages x [16][W]
  float* act = ringp + m.stages * (kSD * W);      // [W][LD]: h_l
  float* inb = act + W * LD;                      // [kin][LD]: the trunk input
  float* red = inb + kin * LD;                    // [kHG][2 column warps][R]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(red + kRed) + 7) & ~static_cast<uintptr_t>(7));
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

  if (warp == kCons / 32) {  // the producer warp: the layers' slices, in order
    if (lane == 0)
      for (int l = 0; l < p.depth; ++l)
        for (int k = 0; k < k_dim<W>(p, l); k += kSD) {
          mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
          mbar_expect_tx(ring.full + 8 * ring.stage, kSliceFW<W>);
          tma_load(ring.base + ring.stage * kSliceFW<W>, &m.wt[l], ring.full + 8 * ring.stage, 0, k);
          ring.advance();
        }
    return;
  }

  // The consumers: four 32-row quarters x two 64-column halves.
  PHASE_START;
  const int wn = warp & 1;
  const int rb = 32 * (warp >> 1) + 4 * (lane >> 3);  // the block's rows rb + R(i)
  const int cb = 64 * wn + 4 * (lane & 7);            // and columns cb + C(j)
  const int row0 = blockIdx.x * R;
  const float* bias = static_cast<const float*>(p.b);
  float acc[8][8];

  // 1. The input tile.
  load_input_rows<R>(inb, static_cast<const float*>(p.x0), p.d0, static_cast<const float*>(p.x1),
                     p.d1, kin, row0, p.n);
  cons_sync();
  PHASE_MARK(0, kScal);

  // 2. The layers: h_l = relu(acc + b_l) to the activation tile (but the
  // last, y), acc keeping y after the last.
  for (int l = 0; l < p.depth; ++l) {
    if (l == 0)
      product<W>(acc, inb, kin, inb, kin, ring, ringp, rb, cb);
    else
      product<W>(acc, act, W, inb, k_dim<W>(p, l), ring, ringp, rb, cb);
    PHASE_MARK(1, kProd);
    cons_sync();  // every consumer's product has read the tiles
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = __ldg(bias + l * W + cb + col_of(j));
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaxf(acc[i][j] + b, 0.f);
    }
    if (l + 1 < p.depth) put_tile<LD>(act, acc, rb, cb);
    cons_sync();
    PHASE_MARK(1, kScal);
  }

  // 3. The f32 heads y wh^T + bh, kHG a pass: the block's partial dot
  // products summed over its row's lanes, then over the 2 column warps in
  // order by a thread a (head, row).
  for (int g = 0; g < p.hf; g += kHG) {
    const int ng = min(kHG, p.hf - g);
    for (int h = 0; h < ng; ++h) {
      const float* wv = p.wh + (g + h) * W;
      float wj[8], v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) wj[j] = __ldg(wv + cb + col_of(j));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i] = fmaf(acc[i][j], wj[j], v[i]);
      }
      red[(h * 2 + wn) * R + rb + row_of(lane & 7)] = row_sums(v);
    }
    cons_sync();
    for (int i = tid; i < ng * R; i += kCons) {
      const int h = i / R, r = i % R, gr = row0 + r;
      if (gr < p.n)
        p.hout[static_cast<size_t>(gr) * p.hf + g + h] =
            red[2 * h * R + r] + red[(2 * h + 1) * R + r] + p.bh[g + h];
    }
    cons_sync();
  }
  PHASE_MARK(2, kScal);
}

// K3 on the wide-input instance: u_x of input columns [c0, c0 + kChunk) in
// the k-major tile ux [kChunk][kLD], folded into ut [kRows][nb]: each value
// first scaled by its partner segment's (xc for a sin column c, -xs for a
// cos column d0 + c: u_m = xc u_xs - xs u_xc, :653-662), read from device
// memory, neighbouring threads reading neighbouring columns of a row; then
// ut[r][j] += the sum over the chunk's columns, in order, of u_m S[c][j],
// a thread a row and 8 basis vectors (S staged in shared memory, fs
// [d0][nbp], rows padded to nbp, a multiple of 8, with zeros: a warp's
// lanes take 32 rows and read one address of S, 8 independent sums a
// lane). All consumers call it; ux is left scaled.
__device__ void fold_chunk(float* ux, float* ut, const float* fs, int nbp, int c0, int row0,
                           const FwdParams& p) {
  const int F = p.d0, nb = p.nb;
  const float* x0 = static_cast<const float*>(p.x0);
  const float* x1 = static_cast<const float*>(p.x1);
  for (int i0 = threadIdx.x; i0 < kRows * kChunk; i0 += kBatch * kCons) {
    float cf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons, c = i % kChunk, k = c0 + c, gr = row0 + i / kChunk;
      cf[u] = 0.f;
      if (i < kRows * kChunk && gr < p.n && k < 2 * F)
        cf[u] = k < F ? __ldg(x1 + static_cast<size_t>(gr) * F + k)
                      : -__ldg(x0 + static_cast<size_t>(gr) * F + k - F);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons;
      if (i < kRows * kChunk) ux[(i % kChunk) * kLD + i / kChunk] *= cf[u];
    }
  }
  cons_sync();
  const int nk = min(kChunk, 2 * F - c0);  // columns past the segments add nothing
  for (int i = threadIdx.x; i < kRows * (nbp / 8); i += kCons) {
    const int r = i % kRows, jb = 8 * (i / kRows);
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < nk; ++c) {
      const int k = c0 + c;
      const float v = ux[c * kLD + r];
      const float4* f4 = reinterpret_cast<const float4*>(fs + (k < F ? k : k - F) * nbp + jb);
      const float4 f0 = f4[0], f1 = f4[1];
      const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int t = 0; t < 8; ++t) s[t] = fmaf(v, f[t], s[t]);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (jb + t < nb) ut[r * nb + jb + t] += s[t];
  }
}

// The wide-input instance (WIDE): the spatial trunk at width 256 on more
// than 256 input columns (up to kWideKin), with sigma and the f32 heads (the
// bottleneck and K3: HC and DG below; no fused stage): mip-NeRF 360's
// proposal MLP, 504 IPE columns. The input tile does not fit beside the activation
// tile and a ring (139 KB at 512 columns), so layer 0's input share, and
// the skip layer's, stream through a k-major [kChunk][kLD] tile: load a
// chunk of columns, sum its product into the block (`product_add`), next
// chunk. The weights stream as in the body below, from the same schedule of
// slices; the heads are its step 3.
//
// HC: the compute-dtype head (128 or 256 wide: the MLP's bottleneck), the
// body's step 4 (a full-width product at 256), y then left in the
// activation tile. DG: K3, the body's step 5, but u_x never lies whole in
// shared memory ([512][68] f32 is 139 KB): its products come 128 input
// columns at a time into the chunk tile, each folded at once into u [64][nb]
// (`fold_chunk`), the partner segment's values (xc for a sin column, -xs for
// a cos one) read from device memory.
template <int HC, bool DG>
__device__ __forceinline__ void fwd_f32_wide(const FwdParams& p, const MapsF32& m,
                                             unsigned char* smem) {
  const int kin = p.kin;
  float* ringp = reinterpret_cast<float*>(smem);  // stages x [16][256]
  float* act = ringp + m.stages * (kSD * kW);     // [256][kLD]: h_l (DG: then s_l)
  float* chunk = act + kW * kLD;                  // [kChunk][kLD]: input columns (DG: then u_x)
  float* red = chunk + kChunk * kLD;              // [kHG][4][kRows]
  uint2* masks = reinterpret_cast<uint2*>(red + kRed);  // DG: [depth][256]
  float* ut = reinterpret_cast<float*>(masks + (DG ? p.depth * kCons : 0));  // DG: u [kRows][nb]
  const int nbp = (p.nb + 7) & ~7;
  float* fs = ut + (DG ? kRows * p.nb : 0);  // DG: the fold S [d0][nbp]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(fs + (DG ? p.d0 * nbp : 0)) + 7) &
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

  if (warp == kCons / 32) {  // the producer warp: the layers' slices, in order
    if constexpr (HC == 0 && !DG) {
      if (lane == 0)
        for (int l = 0; l < p.depth; ++l)
          for (int k = 0; k < k_dim(p, l); k += kSD) {
            mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
            mbar_expect_tx(ring.full + 8 * ring.stage, kSliceF);
            tma_load(ring.base + ring.stage * kSliceF, &m.wt[l], ring.full + 8 * ring.stage, 0, k);
            ring.advance();
          }
    } else if (lane == 0) {
      auto load = [&](const CUtensorMap* map, int col, int K) {
        for (int k = 0; k < K; k += kSD) {
          mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
          mbar_expect_tx(ring.full + 8 * ring.stage, kSliceF);
          tma_load(ring.base + ring.stage * kSliceF, map, ring.full + 8 * ring.stage, col, k);
          ring.advance();
        }
      };
      for (int l = 0; l < p.depth; ++l) load(&m.wt[l], 0, k_dim(p, l));  // the layers
      if (HC > 0) load(&m.wc, 0, kW);                                      // the bottleneck
      if (DG)                                                              // K3's chain
        for (int l = p.depth - 1; l >= 0; --l) {
          if (l == p.skip)
            for (int c = 0; c < kin; c += kChunk) load(&m.w[l], kW + c, kW);  // u_x: skip
          if (l > 0)
            load(&m.w[l], 0, kW);  // s_{l-1}
          else
            for (int c = 0; c < kin; c += kChunk) load(&m.w[0], c, kW);  // u_x: layer 0's
        }
    }
    return;
  }

  PHASE_START;
  const int wn = warp & 3;
  const int rb = 32 * (warp >> 2) + 4 * (lane >> 3);
  const int cb = 64 * wn + 4 * (lane & 7);
  [[maybe_unused]] const int cbh = 32 * wn + 4 * (lane & 7);  // a half-width block's, cbh + j
  const int row0 = blockIdx.x * kRows;
  const float* bias = static_cast<const float*>(p.b);
  const int nd = p.wd != nullptr ? 1 : 0, nh = nd + p.hf;
  float acc[8][8];
  // acc += the input share: the kin input rows of the layer's slices.
  auto input_share = [&]() {
    for (int c0 = 0; c0 < kin; c0 += kChunk) {
      const int kc = min(kChunk, kin - c0);
      cons_sync();  // every consumer is done with the last chunk
      load_input_cols(chunk, static_cast<const float*>(p.x0), p.d0,
                      static_cast<const float*>(p.x1), p.d1, c0, kc, row0, p.n);
      cons_sync();
      PHASE_MARK(0, kScal);
      product_add(acc, chunk, kc, ring, ringp, rb, cb);
      PHASE_MARK(1, kProd);
    }
  };

  // The layers: h_l = relu(acc + b_l) to the activation tile, acc keeping y
  // after the last.
  for (int l = 0; l < p.depth; ++l) {
    if (l == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    } else {
      product(acc, act, kW, act, kW, ring, ringp, rb, cb);
      PHASE_MARK(1, kProd);
    }
    if (l == 0 || l == p.skip) input_share();
    cons_sync();  // every consumer's product has read the tiles
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = __ldg(bias + l * kW + cb + col_of(j));
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaxf(acc[i][j] + b, 0.f);
    }
    if constexpr (DG) {
      uint2 mk = make_uint2(0u, 0u);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t bit = (acc[i][j] > 0.f ? 1u : 0u) << ((8 * i + j) & 31);
          if (i < 4) mk.x |= bit; else mk.y |= bit;
        }
      masks[l * kCons + tid] = mk;
    }
    if (l + 1 < p.depth || HC > 0) put_tile(act, acc, rb, cb);
    cons_sync();
    PHASE_MARK(1, kScal);
  }

  // sigma = y wd and the f32 heads y wh^T + bh from the registers, as the
  // body's step 3.
  for (int g = 0; g < nh; g += kHG) {
    const int ng = min(kHG, nh - g);
    for (int h = 0; h < ng; ++h) {
      const int hh = g + h;
      const float* wv = hh < nd ? p.wd : p.wh + (hh - nd) * kW;
      float wj[8], v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) wj[j] = __ldg(wv + cb + col_of(j));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i] = fmaf(acc[i][j], wj[j], v[i]);
      }
      red[(h * 4 + wn) * kRows + rb + row_of(lane & 7)] = row_sums(v);
    }
    cons_sync();
    if (tid < ng * kRows) {
      const int h = tid / kRows, r = tid % kRows, hh = g + h, gr = row0 + r;
      const float* rr = red + h * 4 * kRows + r;
      const float s = ((rr[0] + rr[kRows]) + rr[2 * kRows]) + rr[3 * kRows];
      if (gr < p.n) {
        if (hh < nd)
          p.sig[gr] = s;
        else
          p.hout[static_cast<size_t>(gr) * p.hf + hh - nd] = s + p.bh[hh - nd];
      }
    }
    cons_sync();
  }
  PHASE_MARK(2, kScal);

  // The bottleneck hc = y wc^T + bc from its accumulators, as the body's
  // step 4: a half-width product at 128, a full one at 256.
  if constexpr (HC == 128) {
    Half h;
    product_half(h, act, kW, ring, ringp, rb, cbh);
    PHASE_MARK(2, kProd);
    const float4 b4 = *reinterpret_cast<const float4*>(static_cast<const float*>(p.bc) + cbh);
    float* out = static_cast<float*>(p.cout);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gr = row0 + rb + row_of(i);
      if (gr < p.n)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(gr) * HC + cbh) = make_float4(
            h[i][0] + b4.x, h[i][1] + b4.y, h[i][2] + b4.z, h[i][3] + b4.w);
    }
    PHASE_MARK(2, kStore);
  } else if constexpr (HC == 256) {
    product(acc, act, kW, act, kW, ring, ringp, rb, cb);
    PHASE_MARK(2, kProd);
    const float* bc = static_cast<const float*>(p.bc);
    const float4 b0 = *reinterpret_cast<const float4*>(bc + cb);
    const float4 b1 = *reinterpret_cast<const float4*>(bc + cb + 32);
    float* out = static_cast<float*>(p.cout);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gr = row0 + rb + row_of(i);
      if (gr >= p.n) continue;
      float* d = out + static_cast<size_t>(gr) * HC + cb;
      *reinterpret_cast<float4*>(d) = make_float4(acc[i][0] + b0.x, acc[i][1] + b0.y,
                                                  acc[i][2] + b0.z, acc[i][3] + b0.w);
      *reinterpret_cast<float4*>(d + 32) = make_float4(acc[i][4] + b1.x, acc[i][5] + b1.y,
                                                       acc[i][6] + b1.z, acc[i][7] + b1.w);
    }
    PHASE_MARK(2, kStore);
  }

  // K3: the chain s_{L-1} = relu'(h) wd, s_{l-1} = relu'(h_{l-1}) (s_l
  // Wa_l), as the body's step 5; u_x of the skip layer's input columns,
  // then of layer 0's, 128 a product into the chunk tile, each folded into
  // ut.
  if constexpr (DG) {
    cons_sync();  // the bottleneck's product has read y
    for (int i = tid; i < kRows * p.nb; i += kCons) ut[i] = 0.f;
    for (int i = tid; i < p.d0 * nbp; i += kCons) {  // the fold, its rows padded with zeros
      const int c = i / nbp, j = i - c * nbp;
      fs[i] = j < p.nb ? __ldg(p.fold + c * p.nb + j) : 0.f;
    }
    {
      const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float q = __ldg(p.wd + cb + col_of(j));
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = bit_at(mk, 8 * i + j) ? q : 0.f;
      }
    }
    put_tile(act, acc, rb, cb);
    cons_sync();
    PHASE_MARK(3, kScal);
    auto take_ux = [&]() {
      for (int c0 = 0; c0 < kin; c0 += kChunk) {
        Half h;
        product_half(h, act, kW, ring, ringp, rb, cbh);
        put_ux<4>(chunk, h, kChunk, true, rb, cbh);
        cons_sync();
        PHASE_MARK(3, kProd);
        fold_chunk(chunk, ut, fs, nbp, c0, row0, p);
        cons_sync();  // the chunk's products may be overwritten
        PHASE_MARK(3, kScal);
      }
    };
    for (int l = p.depth - 1; l > 0; --l) {
      if (l == p.skip) take_ux();
      product(acc, act, kW, act, kW, ring, ringp, rb, cb);
      PHASE_MARK(3, kProd);
      cons_sync();
      const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (!bit_at(mk, 8 * i + j)) acc[i][j] = 0.f;
      put_tile(act, acc, rb, cb);
      cons_sync();
      PHASE_MARK(3, kScal);
    }
    take_ux();
    for (int i = tid; i < min(kRows, p.n - row0) * p.nb; i += kCons)
      p.u[static_cast<size_t>(row0) * p.nb + i] = ut[i];
    PHASE_MARK(3, kStore);
  }
}

// W: the trunk width, 256, or 128 for the plain directional trunk alone
// (`fwd_f32_rows`; the rest of this body is width 256's).
// WIDE: the wide-input instance (`fwd_f32_wide`).
// DG there: K3.
template <int HC, bool DIR, bool SPA, int W = kW, bool WIDE = false, bool DG = false>
__global__ void __launch_bounds__(kTmaThreads, 1)
    trunk_fwd_f32_kernel(const __grid_constant__ FwdParams p, const __grid_constant__ MapsF32 m) {
  static_assert(W == kW || (HC == 0 && !DIR && !SPA), "width 128: the plain K2 alone");
  static_assert(!WIDE || (W == kW && (HC == 0 || HC == 128 || HC == 256) && !DIR && !SPA),
                "wide: sigma, f32 heads, the bottleneck, K3");
  static_assert(WIDE || !DG, "DG: the wide-input instance's");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  if constexpr (W != kW) {
    fwd_f32_rows<W>(p, m, smem);
    return;
  }
  if constexpr (WIDE) {
    fwd_f32_wide<HC, DG>(p, m, smem);
    return;
  }
  const int kin = p.kin;
  const bool dg = !DIR && p.u != nullptr;  // K3: never with K8-K10
  const int tiles = SPA ? p.tiles : 1;
  float* ringp = reinterpret_cast<float*>(smem);              // stages x [16][256]
  float* act = ringp + m.stages * (kSD * kW);                 // [256][kLD]: h_l, K3's s_l
  float* inb = act + kW * kLD;                                // [kin][kLD]: the trunk input
  uint2* masks = reinterpret_cast<uint2*>(inb + kin * kLD);   // K3: [depth][256]
  float* ux = reinterpret_cast<float*>(masks + (dg ? p.depth * kCons : 0));  // K3: [kin][kLD]
  float* red = ux + (dg ? kin * kLD : 0);  // [kHG][4][kRows]; K7's staged lm, lv
  float* hv = red + kRed;                  // K10: the rgb head [kRows][3]
  float* sraw = hv + 3 * kRows;            // K6: the raw density [tiles * kRows]
  const int nsraw = SPA && p.wts != nullptr ? tiles * kRows : 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(sraw + nsraw) + 7) & ~static_cast<uintptr_t>(7));
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
      for (int tile = 0; tile < tiles; ++tile)
        schedule<HC>(p, m, [&](const CUtensorMap* map, int col, int K) {
          for (int k = 0; k < K; k += kSD) {
            mbar_wait(ring.empty + 8 * ring.stage, ring.phase ^ 1u);
            mbar_expect_tx(ring.full + 8 * ring.stage, kSliceF);
            tma_load(ring.base + ring.stage * kSliceF, map, ring.full + 8 * ring.stage, col, k);
            ring.advance();
          }
        });
    }
    return;
  }

  // The consumers.
  PHASE_START;
  const int wm = warp >> 2, wn = warp & 3;
  const int rb = 32 * wm + 4 * (lane >> 3);  // the block's rows rb + R(i)
  const int cb = 64 * wn + 4 * (lane & 7);   // and columns cb + C(j)
  const int cbh = 32 * wn + 4 * (lane & 7);  // a half-width block's, cbh + j
  const float* bias = static_cast<const float*>(p.b);
  const int nd = p.wd != nullptr ? 1 : 0, nh = nd + p.hf;
  float acc[8][8];
  // K3's u_x of a layer's input columns: half-width within 128 of them.
  auto take_ux = [&](bool first) {
    if (kin <= 128) {
      Half h;
      product_half(h, act, kW, ring, ringp, rb, cbh);
      put_ux<4>(ux, h, kin, first, rb, cbh);
    } else {
      product(acc, act, kW, act, kW, ring, ringp, rb, cb);
      put_ux<8>(ux, acc, kin, first, rb, cb);
    }
  };

  for (int tile = 0; tile < tiles; ++tile) {
    const int row0 = (blockIdx.x * tiles + tile) * kRows;
    if (tile > 0) cons_sync();  // the last tile's reads of its tiles and red are done

    // 1. The input tile (with K7 the IPE, with K8/K9 the IDE block made here).
    if constexpr (SPA) {
      if (p.ipe.lm != nullptr)
        load_ipe_f32(inb, stage_ipe(p.ipe, red, row0, p.n), p.d0, kin, row0, p.n);
      else
        load_input_f32<false>(inb, static_cast<const float*>(p.x0), p.d0,
                              static_cast<const float*>(p.x1), p.d1, kin, row0, p.n, p.dir);
    } else {
      load_input_f32<DIR>(inb, static_cast<const float*>(p.x0), p.d0,
                          static_cast<const float*>(p.x1), p.d1, kin, row0, p.n, p.dir);
    }
    cons_sync();
    PHASE_MARK(0, kScal);

    // 2. The layers: h_l = relu(acc + b_l) to the activation tile (y only
    // for the bottleneck), with K3 the relu' bits in the block's order; acc
    // keeps y after the last.
    for (int l = 0; l < p.depth; ++l) {
      if (l == 0)
        product(acc, inb, kin, inb, kin, ring, ringp, rb, cb);
      else
        product(acc, act, kW, inb, k_dim(p, l), ring, ringp, rb, cb);
      PHASE_MARK(1, kProd);
      cons_sync();  // every consumer's product has read the tiles
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b = __ldg(bias + l * kW + cb + col_of(j));
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaxf(acc[i][j] + b, 0.f);
      }
      if (dg) {
        uint2 mk = make_uint2(0u, 0u);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t bit = (acc[i][j] > 0.f ? 1u : 0u) << ((8 * i + j) & 31);
            if (i < 4) mk.x |= bit; else mk.y |= bit;
          }
        masks[l * kCons + tid] = mk;
      }
      if (l + 1 < p.depth || HC > 0) put_tile(act, acc, rb, cb);
      cons_sync();
      PHASE_MARK(1, kScal);
    }

    // 3. sigma = y wd and the f32 heads y wh^T + bh from the registers, kHG
    // heads a pass: the block's partial dot products summed over its row's
    // lanes, then over the 4 column warps in order by a thread a (head,
    // row). K6 keeps sigma, K10 the rgb head.
    for (int g = 0; g < nh; g += kHG) {
      const int ng = min(kHG, nh - g);
      for (int h = 0; h < ng; ++h) {
        const int hh = g + h;
        const float* wv = hh < nd ? p.wd : p.wh + (hh - nd) * kW;
        float wj[8], v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) wj[j] = __ldg(wv + cb + col_of(j));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) v[i] = fmaf(acc[i][j], wj[j], v[i]);
        }
        const float s = row_sums(v);
        red[(h * 4 + wn) * kRows + rb + row_of(lane & 7)] = s;
      }
      cons_sync();
      if (tid < ng * kRows) {
        const int h = tid / kRows, r = tid % kRows, hh = g + h, gr = row0 + r;
        const float* rr = red + h * 4 * kRows + r;
        const float s = ((rr[0] + rr[kRows]) + rr[2 * kRows]) + rr[3 * kRows];
        if (gr < p.n) {
          if (hh < nd) {
            p.sig[gr] = s;
            if constexpr (SPA) {
              if (p.wts != nullptr) sraw[tile * kRows + r] = s;
            }
          } else {
            const float o = s + p.bh[hh - nd];
            p.hout[static_cast<size_t>(gr) * p.hf + hh - nd] = o;
            if constexpr (DIR) {
              if (p.rgb != nullptr) hv[r * 3 + hh - nd] = o;
            }
          }
        }
      }
      cons_sync();
    }
    if constexpr (DIR) {
      if (p.rgb != nullptr) {  // K10 on the rgb head just summed
        if (tid < kRows && row0 + tid < p.n) {
          const size_t o = static_cast<size_t>(row0 + tid) * 3;
          float out[3], unused[3];
          rgb_epilogue(hv + tid * 3, p.rgbe.rawd + o, p.rgbe.rawt + o, p.rgbe, out, nullptr,
                       unused, unused, unused);
#pragma unroll
          for (int c = 0; c < 3; ++c) p.rgb[o + c] = out[c];
        }
      }
    }
    PHASE_MARK(2, kScal);

    // 4. The bottleneck hc = y wc^T + bc, a half-width product, from its
    // accumulators to device memory.
    if constexpr (HC > 0) {
      static_assert(WIDE || HC == 128, "the bottleneck is a half-width product");
      Half h;
      product_half(h, act, kW, ring, ringp, rb, cbh);
      PHASE_MARK(2, kProd);
      const float4 b4 = *reinterpret_cast<const float4*>(static_cast<const float*>(p.bc) + cbh);
      float* out = static_cast<float*>(p.cout);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int gr = row0 + rb + row_of(i);
        if (gr < p.n)
          *reinterpret_cast<float4*>(out + static_cast<size_t>(gr) * HC + cbh) = make_float4(
              h[i][0] + b4.x, h[i][1] + b4.y, h[i][2] + b4.z, h[i][3] + b4.w);
      }
      PHASE_MARK(2, kStore);
    }

    // 5. K3: the chain s_{L-1} = relu'(h) wd, s_{l-1} = relu'(h_{l-1}) (s_l
    // Wa_l), the masks applied in each product's epilogue; u_x = s_skip
    // Wx_skip + s_0 Wx_0 in the f32 tile ux; then the fold u = (xc u_xs - xs
    // u_xc) S (K7: e (cos m u_xs - sin m u_xc) S).
    if (dg) {
      cons_sync();  // the bottleneck's product has read y
      {
        const uint2 mk = masks[(p.depth - 1) * kCons + tid];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float q = __ldg(p.wd + cb + col_of(j));
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = bit_at(mk, 8 * i + j) ? q : 0.f;
        }
      }
      put_tile(act, acc, rb, cb);
      cons_sync();
      PHASE_MARK(3, kScal);
      for (int l = p.depth - 1; l > 0; --l) {
        if (l == p.skip) {
          take_ux(true);
          PHASE_MARK(3, kProd);
        }
        product(acc, act, kW, act, kW, ring, ringp, rb, cb);
        PHASE_MARK(3, kProd);
        cons_sync();
        const uint2 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!bit_at(mk, 8 * i + j)) acc[i][j] = 0.f;
        put_tile(act, acc, rb, cb);
        cons_sync();
        PHASE_MARK(3, kScal);
      }
      take_ux(p.skip <= 0);
      cons_sync();
      PHASE_MARK(3, kProd);

      // The fold, as trunk_fwd.cu: u_m in place of u_xs, then u = u_m S, a
      // thread a (row, basis vector).
      const int F = p.d0, nb = p.nb;
      bool k7 = false;
      if constexpr (SPA) k7 = p.ipe.lm != nullptr;
      Ipe q{};
      if (k7) q = stage_ipe(p.ipe, red, row0, p.n);
      for (int i = tid; i < kRows * F; i += kCons) {
        const int r = i % kRows, c = i / kRows;
        float* u0 = ux + c * kLD + r;
        if (k7) {  // e (cos m u_xs - sin m u_xc) in f32 (:657-659)
          if (row0 + r >= p.n) continue;
          float e, sn, cs;
          ipe_trig(q, r, c, e, sn, cs);
          *u0 = mul(e, sub(mul(cs, u0[0]), mul(sn, u0[F * kLD])));
        } else {  // xc u_xs - xs u_xc
          *u0 = inb[(F + c) * kLD + r] * u0[0] - inb[c * kLD + r] * u0[F * kLD];
        }
      }
      cons_sync();
      for (int i = tid; i < kRows * nb; i += kCons) {
        const int r = i / nb, j = i % nb, gr = row0 + r;
        if (gr >= p.n) continue;
        float s = 0.f;
        for (int c = 0; c < F; ++c) s = fmaf(ux[c * kLD + r], p.fold[c * nb + j], s);
        p.u[static_cast<size_t>(gr) * nb + j] = s;
      }
      PHASE_MARK(3, kScal);
    }
  }

  // K6: the weights of the CTA's rays, one warp a ray.
  if constexpr (SPA) {
    if (p.wts != nullptr) {
      cons_sync();
      const int base = blockIdx.x * tiles * kRows, S = p.samples;
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

// Shared memory of a launch at width W, and the ring's stages that fit (0
// when fewer than kMinStages do). fused_mlp.py `kernel_smem` mirrors this
// sum. Width 128 has no K3, K6 or K10 (hv).
template <int W = kW>
size_t fwd_f32_smem(const FwdParams& p, int* stages) {
  const size_t rest =
      1024 + 4 * static_cast<size_t>(W + p.kin) * kLDW<W> +
      (p.u != nullptr ? 8 * static_cast<size_t>(p.depth) * kCons +
                            4 * static_cast<size_t>(p.kin) * kLD
                      : 0) +
      4 * static_cast<size_t>(kRed + (W == kW ? 3 * kRows : 0)) +
      (p.wts != nullptr ? 4 * static_cast<size_t>(p.tiles) * kRows : 0) + 8 + 16 * kMaxStages;
  const size_t fit = rest < 232448 ? (232448 - rest) / kSliceFW<W> : 0;
  *stages = fit < kMinStages ? 0 : static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return rest + static_cast<size_t>(*stages) * kSliceFW<W>;
}

// Shared memory of a launch of the wide-input instance, and the ring's
// stages that fit (0 when fewer than kMinStages do); with K3 (`dg`) also its
// relu' bits, u and the fold, its rows padded to a multiple of 8.
// fused_mlp.py `kernel_smem` mirrors this sum.
size_t fwd_f32_wide_smem(const FwdParams& p, int* stages, bool dg) {
  const size_t rest = 1024 + 4 * static_cast<size_t>(kW + kChunk) * kLD + 4 * kRed +
                      (dg ? 8 * static_cast<size_t>(p.depth) * kCons + 4 * kRows * p.nb +
                                4 * static_cast<size_t>(p.d0) * ((p.nb + 7) & ~7)
                          : 0) +
                      8 + 16 * kMaxStages;
  const size_t fit = rest < 232448 ? (232448 - rest) / kSliceF : 0;
  *stages = fit < kMinStages ? 0 : static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return rest + static_cast<size_t>(*stages) * kSliceF;
}

template <int HC, bool DIR, bool SPA, int W = kW, bool WIDE = false, bool DG = false>
int launch_fwd_f32(const FwdParams& p, cudaStream_t stream) {
  // K7's staged inputs must fit in red.
  if (SPA && p.ipe.lm != nullptr && 2 * kRows * p.ipe.nb > kRed)
    return static_cast<int>(cudaErrorInvalidValue);
  MapsF32 m;
  memset(&m, 0, sizeof(m));
  bool ok = make_layer_maps_f32<W>(m, p.w, p.wt, p.depth, p.kin, p.skip);
  if (HC > 0) ok = ok && make_map_f32(&m.wc, p.wc, HC, kW, HC, kW, kSD);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      WIDE ? fwd_f32_wide_smem(p, &m.stages, DG) : fwd_f32_smem<W>(p, &m.stages);
  if (m.stages == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(trunk_fwd_f32_kernel<HC, DIR, SPA, W, WIDE, DG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = W == kW ? (SPA ? p.tiles : 1) * kRows : kRowsW<W>;
  trunk_fwd_f32_kernel<HC, DIR, SPA, W, WIDE, DG>
      <<<(p.n + rows - 1) / rows, kTmaThreads, smem, stream>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes, with refnerf_trunk_fwd's arguments (trunk_fwd.cu):
// the f32 trunk (dtype 0) of at most kMaxDepth layers, kW input columns and
// kMaxHeads f32 heads, without K11's y; at width 256 K1/K3 (hc 128 or 0;
// with K6/K7, hc 128) and K2 (hc 0; with K8-K10, never with K3), at width
// 128 the plain K2 alone (hc 0, no density head, K3 or fused stage), 128
// samples a CTA; past kW and up to kWideKin input columns the spatial trunk
// at width 256 with sigma, the f32 heads and the compute-dtype head (hc 0,
// 128 or 256) and K3 (nb <= kMaxNbWide), no fused stage (the wide-input
// instance). `wc` is the compute-dtype head transposed, wc^T
// [width][hc] (its product reads the contraction index outermost). Returns
// the cudaError_t of the launch (0 on success); allocates nothing and does
// not synchronise.
extern "C" int refnerf_trunk_fwd_f32(REFNERF_FWD_ARGS) {
  FwdParams p;
  const int err = fwd_params(p, REFNERF_FWD_NAMES);
  if (err != 0) return err;
  if (dtype != 0 || (width != kW && width != 128) || depth < 1 || depth > kMaxDepth ||
      kin > kWideKin || hf > kMaxHeads || y != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dir = p.dir.p != 0 || p.rgb != nullptr;
  const bool spa = p.ipe.lm != nullptr || p.wts != nullptr;
  if (kin > kW) {  // the wide-input instance: sigma, the heads, K3
    if (width != kW || dir || spa) return static_cast<int>(cudaErrorInvalidValue);
    if (u != nullptr)
      return hc == 0     ? launch_fwd_f32<0, false, false, kW, true, true>(p, s)
             : hc == 128 ? launch_fwd_f32<128, false, false, kW, true, true>(p, s)
             : hc == 256 ? launch_fwd_f32<256, false, false, kW, true, true>(p, s)
                         : static_cast<int>(cudaErrorInvalidValue);
    return hc == 0     ? launch_fwd_f32<0, false, false, kW, true>(p, s)
           : hc == 128 ? launch_fwd_f32<128, false, false, kW, true>(p, s)
           : hc == 256 ? launch_fwd_f32<256, false, false, kW, true>(p, s)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 128)
    return hc == 0 && !dir && !spa && u == nullptr && wd == nullptr
               ? launch_fwd_f32<0, false, false, 128>(p, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (hc == 0 && !spa && dir)  // never with K3
    return u == nullptr ? launch_fwd_f32<0, true, false>(p, s)
                        : static_cast<int>(cudaErrorInvalidValue);
  if (hc == 0 && !spa) return launch_fwd_f32<0, false, false>(p, s);
  if (hc == 128 && !dir)
    return spa ? launch_fwd_f32<128, false, true>(p, s) : launch_fwd_f32<128, false, false>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 backward (K4, first order and with u's cotangent) of the
// wide-input spatial trunk on Hopper's tensor cores: three TF32 passes of
// wgmma fed by TMA.
//
// Replaces, for the compute dtype float32 on the JAX package's default
// spatial trunk (8 x 256 on two IPE segments of d <= 256 columns each, 504
// at the defaults, the skip at one layer, the density head and the 256-wide
// compute-dtype head, no f32 heads), the per-tile part of the backward
// Pallas kernel `_bwd_kernel` (refnerf_tpu/ops/pallas/fused_mlp.py
// :668-853): the recompute h_l = relu(acc + b_l), the head backward
// zeta_{L-1} = relu'(h_{L-1}) (cbar wc + sbar wd), the reverse zeta_{l-1} =
// relu'(h_{l-1}) (zeta_l Wa_l), and with u's cotangent the second-order
// pass (:822-853): the inner chain s_{L-1} = relu'(h_{L-1}) wd, s_{l-1} =
// relu'(h_{l-1}) (s_l Wa_l), tp = ubar S^T, ts = (tp xc, -(tp xs)), the
// tangent chain p_l = relu'(h_l) ([p_{l-1} | ts] W_l). trunk_bwd_f32.cu's
// `bwd_f32_wide<256, DG>` ran it before on the FMA pipes and keeps the
// other wide-input shapes.
//
// The kernel writes the weight gradients' operands to the scratch,
// sample-major: h_l, zeta_l, s_l, p_l [depth][rp][256], the input x and its
// tangent ts [rp][512] (each segment's d columns, zeros past 2 d). The
// wrapper (`fused_mlp._wide_tf32_backward`) forms dW_l = zeta_l^T [h_{l-1} |
// x] + s_l^T [p_{l-1} | ts], dwc = cbar^T y and the bias gradients (zeta's
// and cbar's column sums) on trunk_w1024.cu's f32 tn product (three TF32
// passes), dwd = sum sbar y + sum p_{L-1} by its column sums, and
// trunk_bwd.cu's refnerf_reduce sums the partials in a fixed order.
//
// Bound at 524,288 rows on an H100 (chip_smoke.py `trunk_flops`: 4.107
// TFLOP with u's cotangent, 2.122 first order): as three TF32 products at
// 495 TFLOP/s, 24.9 and 12.9 ms.
//
// The design is trunk_wide_tf32.cu's (K3; the pieces in wide_tf32.cuh):
//  - A CTA owns a 64-row tile: two consumer warpgroups and a producer
//    warpgroup (its first thread issues the TMA loads; setmaxnreg 40 and
//    232); consumer warpgroup c owns
//    output columns [128 c, 128 c + 128) of every product (wgmma m64n128k8
//    TF32: hi = tf32(v), lo = tf32(v - hi), lo.hi + hi.lo + hi.hi, each
//    32-deep slice summed into fresh accumulators that are added into the
//    tile in f32: H26).
//  - B is every product's weights as 256 x 256 panels in the order the tile
//    runs them (`fused_mlp.tf32_bwd_panel_index`), split once a call into
//    their TF32 parts by trunk_wide_tf32.cu's `refnerf_wide_tf32_split`: the
//    recompute's are K3's layers; the inner chain's and the reverse's W_l^T
//    (zeta W_l contracts as s W_l does); the head's wc (K = 256); the
//    tangent's the layers' again, layer 0's and the skip layer's input share
//    two panels of 256 of the tangent's columns. tp's B is one [256][32]
//    slice of its own (S, K = the basis padded to 32: `fused_mlp.
//    tf32_tp_index`). K is permuted within every 8 so that the accumulators
//    of an epilogue are the next product's A fragments.
//  - A comes from registers: the activation tile (f32 [64][256] in shared
//    memory as eight [64][32] boxes swizzled as TMA writes them), or the
//    [64][32] boxes that the producer brings by TMA beside each slice of B:
//    the segments (the recompute), cbar (the head) and the ts scratch (the
//    tangent), zeros past their columns and rows; tp's A, ubar, from device
//    memory.
//  - ts is made once: tp is the tile's first product; each thread scales its
//    accumulators by the partner segment's values, stores ts to the scratch
//    (which the weight gradients read anyway) and fences its stores for the
//    async proxy (fence.proxy.async.global) before it arrives on an
//    mbarrier, which the producer waits on before its first TMA read of ts.
//  - Layer 0's input reaches the x scratch from the slices warpgroup 0 reads
//    in its recompute (`product_bwd<true>`).
//  - Epilogues in registers: the bias, ReLU and relu' as 64 bits a thread and
//    layer (the last layer's kept in registers), the masks, the head's
//    sigma term. Each value leaves through the activation tile: a TMA store
//    of its eight boxes (one thread issuing) writes it to the scratch while
//    the next product runs, and the next epilogue waits for the store to
//    have read the tile. No float atomics and no sums across threads:
//    reruns are bit-identical.
// One CTA an SM (228,392 B of shared memory at depth 8; `kernel_smem` in
// fused_mlp.py mirrors `bwd_smem_bytes`).
//
// The same kernel runs the first-order K4 of mip-NeRF 360's proposal trunk
// (`refnerf_wide_tf32_k4h0`: the f32 PropMLP, 4 x 256 on 2 x 252 IPE
// columns with the density head alone, no skip layer; trunk_bwd_f32.cu's
// `bwd_f32_wide<0, false>` before) under a flag, H0: without a
// compute-dtype head the head backward is no product, zeta_{L-1} =
// relu'(h_{L-1}) (sbar wd), an outer product made in the recompute's last
// epilogue; no cbar, wc panel or tensor map (8 panels at depth 4: the
// recompute's 5 and the reverse's 3). The wrapper forms dW_l and db_l as
// above; dwd = sum sbar y is summed in the kernel, a tile's share from y
// in registers (never stored), and the wrapper sums the tiles' shares in a
// fixed order; there is no dwc or dbc. Bound at 524,288
// rows (0.890 TFLOP at depth 4): as three TF32 products 5.39 ms (13.28 ms
// on the FMA pipes).

#define PHASE_SYNC() cons_sync()  // closes a stamped segment
#include "wide_tf32.cuh"

namespace wtf {

constexpr int kInLd = 2 * kWidth;  // row stride of the x and ts scratch

// Dynamic shared memory of a launch: 1 KB to align the swizzled tiles, the
// ring, the activation tile, the input slots (one a stage), the relu' bits
// of layers 0 to depth - 2, the ring's mbarriers and the one of ts.
inline size_t bwd_smem_bytes(int depth) {
  return 1024 + static_cast<size_t>(kStages) * kStage + 4 * kRows * kWidth + kStages * kXBox +
         8 * static_cast<size_t>(depth - 1) * 256 + 8 * (2 * kStages + 1);
}

// The weight panels of a tile in order: the recompute (layer 0 one a
// segment, each hidden layer's activation share, the skip layer's input one
// a segment), with u's cotangent the inner chain's W_l^T (depth - 1), the
// head's wc (not without the head: `head`), the reverse's W_l^T (depth -
// 1), with u's cotangent the tangent's layers (as the recompute's).
__host__ __device__ inline int bwd_panels(int depth, int skip, bool dg, bool head = true) {
  const int layers = 2 + (depth - 1) + (skip > 0 && skip < depth ? 2 : 0);
  return layers + (head ? 1 : 0) + (depth - 1) + (dg ? (depth - 1) + layers : 0);
}

struct BwdParams {
  const float* x0;    // [n][d]: the sin segment
  const float* x1;    // [n][d]: the cos segment
  int d, n, rp, depth, skip, nb;
  const float* b;     // [depth][256]
  const float* wd;    // [256]
  const float* sbar;  // [n]
  const float* ubar;  // [n][nb] (with u's cotangent)
  float* hs;          // [depth][rp][256] h_l
  float* zs;          // [depth][rp][256] zeta_l
  float* ss;          // [depth][rp][256] s_l (with u's cotangent)
  float* ps;          // [depth][rp][256] p_l (with u's cotangent)
  float* xs;          // [rp][kInLd] x
  float* ts;          // [rp][kInLd] ts (with u's cotangent)
  float* dwd;         // H0: [rp / 64][256] each tile's sum of sbar y
};

struct BwdMaps {
  CUtensorMap bh, bl;  // [np * 256][256] B's parts, boxes [256][32]
  CUtensorMap x0, x1;  // [n][d], boxes [64][32]
  CUtensorMap cbar;    // [n][256], boxes [64][32]
  CUtensorMap ts;      // [rp][kInLd], boxes [64][32]
  CUtensorMap th, tl;  // tp's B parts [256][32], one box
  CUtensorMap hs, zs, ss, ps;  // [depth * rp][256], boxes [64][32] (stores)
};

// acc = A B^T over the ring's next np panels, as wide_tf32.cuh's `product`
// but for the activation tile's layout (box kb holds columns [32 kb, 32 kb +
// 32), as the input slots hold a slice). KEEP (the recompute's layer 0):
// the input slices' values the thread reads also go to the x scratch,
// panel i's (segment i's) columns below d at keep + i d (keep: the thread's
// row ra of the scratch; null but in warpgroup 0).
template <bool KEEP>
__device__ __forceinline__ void product_bwd(float (&acc)[64], float (&part)[64], Cons& c, int np,
                                            int src, float* keep = nullptr, int d = 0) {
  uint32_t h0[4], l0[4], h1[4], l1[4];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;  // neither live before
  int prev = -1;
  for (int i = 0; i < np; ++i) {
    const bool isx = (src >> i) & 1;
    for (int kb = 0; kb < kWidth / kFK; ++kb) {
      mbar_wait(c.r.full + 8 * c.r.stage, c.r.phase);
      const uint32_t bh = c.r.base + c.r.stage * kStage + c.cw * (kPart / 2), bl = bh + kPart;
      const unsigned char* a = isx ? c.xslot + c.r.stage * kXBox
                                   : reinterpret_cast<const unsigned char*>(c.act) + kb * kXBox;
#pragma unroll
      for (int kk = 0; kk < kFK / 8; ++kk) {
        uint32_t(&hi)[4] = (kk & 1) ? h1 : h0;
        uint32_t(&lo)[4] = (kk & 1) ? l1 : l0;
        if (kk == 0) {  // the previous slice's products are done: add them
          wg_wait<0>();
          if (prev >= 0) {
            release(c, prev);
            acc_fence(part);
#pragma unroll
            for (int e = 0; e < 64; ++e) acc[e] += part[e];
          }
        } else {
          wg_wait<1>();
        }
        const int k = 8 * kk + 2 * c.q;  // slots q, q + 4: columns k, k + 1
        const float2 v0 = *reinterpret_cast<const float2*>(a + f32_off(c.ra, k));
        const float2 v1 = *reinterpret_cast<const float2*>(a + f32_off(c.ra + 8, k));
        if constexpr (KEEP) {
          const int col = kFK * kb + k;
          if (isx && keep != nullptr && col < d) {
            *reinterpret_cast<float2*>(keep + i * d + col) = v0;
            *reinterpret_cast<float2*>(keep + 8 * kInLd + i * d + col) = v1;
          }
        }
        split_tf32(v0.x, hi[0], lo[0]);
        split_tf32(v1.x, hi[1], lo[1]);
        split_tf32(v0.y, hi[2], lo[2]);
        split_tf32(v1.y, hi[3], lo[3]);
        wg_fence();
        mma3(part, hi, lo, sw128_desc(bh + 32 * kk, 16, 1024), sw128_desc(bl + 32 * kk, 16, 1024),
             kk);
        wg_commit();
      }
      prev = c.r.stage;
      c.r.advance();
    }
  }
  wg_wait<0>();
  release(c, prev);
  acc_fence(part);
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] += part[e];
}

// Stores v (the thread's 64 values in the accumulators' layout: columns 128
// cw + 8 j + 2 q + e, rows ra + 8 h) to the activation tile's boxes.
__device__ __forceinline__ void put_act_box(unsigned char* act, const float (&v)[64], int cw,
                                            int ra, int q) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 128 * cw + 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(act + (col >> 5) * kXBox + f32_off(ra + 8 * h, col & 31)) =
          make_float2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
  }
}

__device__ __forceinline__ void relu_mask(float (&v)[64], const uint2 m) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    if (!bit(m, i)) v[i] = 0.f;
}

// acc = tp = ubar S^T of the tile's rows, one slice of the ring (tp's
// panel: B[c][k'] = S[c][perm k'], K the basis padded to 32), A = ubar from
// device memory (slots q, q + 4 of step kk: basis vectors 8 kk + 2 q, + 1;
// zeros past nb and past row n), three TF32 passes.
__device__ __forceinline__ void tp_product(float (&acc)[64], Cons& c, const BwdParams& p,
                                           int row0) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + c.ra + 8 * (e & 1), j = 8 * kk + 2 * c.q + (e >> 1);
      const float v =
          row < p.n && j < p.nb ? __ldg(p.ubar + static_cast<size_t>(row) * p.nb + j) : 0.f;
      split_tf32(v, hi[kk][e], lo[kk][e]);
    }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(c.r.full + 8 * c.r.stage, c.r.phase);
  const uint32_t bh = c.r.base + c.r.stage * kStage + c.cw * (kPart / 2), bl = bh + kPart;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma3(acc, hi[kk], lo[kk], sw128_desc(bh + 32 * kk, 16, 1024),
         sw128_desc(bl + 32 * kk, 16, 1024), kk);
  wg_commit();
  wg_wait<0>();
  release(c, c.r.stage);
  acc_fence(acc);
  c.r.advance();
}

// One 64-row tile a CTA. Threads 0-255: the consumers; 256-383: the
// producer warpgroup (thread 256 walks the panels: B's parts, and the A
// boxes of the input panels). DG: with u's cotangent. H0 (first order):
// no compute-dtype head, zeta_{L-1} an outer product.
template <bool DG, bool H0 = false>
__global__ void __launch_bounds__(kWgThreads, 1)
    trunk_bwd_tf32_kernel(const __grid_constant__ BwdParams p, const __grid_constant__ BwdMaps m) {
  static_assert(!(DG && H0), "the head-0 instance is first order");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* act = smem + kStages * kStage;           // 8 x [64][32]
  unsigned char* slots = act + 4 * kRows * kWidth;        // kStages x [64][32]
  uint2* masks = reinterpret_cast<uint2*>(slots + kStages * kXBox);  // [depth - 1][256]
  const uint32_t full = smem_u32(masks + (p.depth - 1) * kCons), empty = full + 8 * kStages;
  const uint32_t ts_ready = empty + 8 * kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons / 32);
    }
    mbar_init(ts_ready, kCons);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int row0 = blockIdx.x * kRows;

  if (warp >= kCons / 32) {
    reg_dealloc<kProdRegs>();
    if (tid == kCons) {
      Ring r{smem_u32(smem), full, empty, kStages, 0, 0u};
      // A slice of B (column bc, row br of the parts' maps), with the A box
      // of map x at column xc beside it where x is given.
      auto slice = [&](const CUtensorMap* bh, const CUtensorMap* bl, int bc, int br,
                       const CUtensorMap* x, int xc) {
        mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
        const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kStage;
        mbar_expect_tx(f, kStage + (x != nullptr ? kXBox : 0));
        tma_load(dst, bh, f, bc, br);
        tma_load(dst + kPart, bl, f, bc, br);
        if (x != nullptr) tma_load(smem_u32(slots) + r.stage * kXBox, x, f, xc, row0);
        r.advance();
      };
      int pn = 0;
      auto panel = [&](const CUtensorMap* x, int xc) {
        for (int kb = 0; kb < kWidth / kFK; ++kb)
          slice(&m.bh, &m.bl, kFK * kb, kWidth * pn, x, xc + kFK * kb);
        ++pn;
      };
      // The layers' panels: layer 0's two input panels, each hidden layer's,
      // at the skip layer its input's two after it (x0 at column 0, x1 at c1).
      auto layers = [&](const CUtensorMap* x0, const CUtensorMap* x1, int c1) {
        panel(x0, 0);
        panel(x1, c1);
        for (int l = 1; l < p.depth; ++l) {
          panel(nullptr, 0);
          if (l == p.skip) {
            panel(x0, 0);
            panel(x1, c1);
          }
        }
      };
      if (DG) slice(&m.th, &m.tl, 0, 0, nullptr, 0);  // tp
      layers(&m.x0, &m.x1, 0);                         // the recompute
      if (DG)
        for (int l = p.depth - 1; l > 0; --l) panel(nullptr, 0);  // the inner chain
      if constexpr (!H0) panel(&m.cbar, 0);                       // the head backward
      for (int l = p.depth - 1; l > 0; --l) panel(nullptr, 0);    // the reverse
      if (DG) {
        mbar_wait(ts_ready, 0);        // the tile's ts stored and fenced
        layers(&m.ts, &m.ts, kWidth);  // the tangent
      }
    }
  } else {
    reg_alloc<kConsRegs>();
    PHASE_START;
    const int ctid = tid, cw = ctid >> 7, cwarp = (ctid >> 5) & 3;
    const int g = lane >> 2, q = lane & 3, ra = 16 * cwarp + g;
    Cons c{Ring{smem_u32(smem), full, empty, kStages, 0, 0u}, slots,
           reinterpret_cast<const float*>(act), cw, ra, q, lane};
    float acc[64], part[64];
    uint2 mlast = make_uint2(0u, 0u);  // relu' of the last layer
    // v to the activation tile once every consumer's product has read it
    // and the last store has left it, then to layer l of a scratch region
    // (map) by TMA, thread 0 issuing; the next product may read the tile.
    auto to_act = [&](const float (&v)[64], const CUtensorMap* map, int l) {
      if (ctid == 0) bulk_wait_read();
      cons_sync();
      put_act_box(act, v, cw, ra, q);
      fence_async_smem();
      cons_sync();
      if (ctid == 0) {
        for (int b = 0; b < kWidth / kFK; ++b)
          tma_store(map, smem_u32(act) + b * kXBox, kFK * b, l * p.rp + row0);
        bulk_commit();
      }
    };

    // 0. Zeros in the x (and ts) scratch past the segments, the tile's rows.
    const int pad = kInLd - 2 * p.d;
    for (int i = ctid; i < kRows * pad; i += kCons) {
      const size_t o = static_cast<size_t>(row0 + i / pad) * kInLd + 2 * p.d + i % pad;
      p.xs[o] = 0.f;
      if (DG) p.ts[o] = 0.f;
    }
    // 1. DG: tp = ubar S^T and ts = (tp xc, -(tp xs)) (the partner
    // segment's values from device memory) to the ts scratch, fenced for
    // the tangent's TMA reads and published to the producer.
    if constexpr (DG) {
      // The partner values a group of 4 column steps j at a time, all of a
      // group's loads issued before any use (the first group's before tp's
      // product): 4 latencies a tile, not 32.
      float2 xv[4][2][2];  // [j % 4][h][xs, xc]
      auto partners = [&](int j0) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + ra + 8 * h, col = 128 * cw + 8 * (j0 + jj) + 2 * q;
            xv[jj][h][0] = xv[jj][h][1] = make_float2(0.f, 0.f);
            if (row < p.n && col < p.d) {
              const size_t o = static_cast<size_t>(row) * p.d + col;
              xv[jj][h][0] = __ldg(reinterpret_cast<const float2*>(p.x0 + o));
              xv[jj][h][1] = __ldg(reinterpret_cast<const float2*>(p.x1 + o));
            }
          }
      };
      partners(0);
      tp_product(acc, c, p, row0);
      PHASE_MARK(6, kProd);
#pragma unroll
      for (int j0 = 0; j0 < 16; j0 += 4) {
        if (j0 > 0) partners(j0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj, col = 128 * cw + 8 * j + 2 * q;
          if (col >= p.d) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 xs = xv[jj][h][0], xc = xv[jj][h][1];
            const float t0 = acc[4 * j + 2 * h], t1 = acc[4 * j + 2 * h + 1];
            float* t = p.ts + static_cast<size_t>(row0 + ra + 8 * h) * kInLd + col;
            *reinterpret_cast<float2*>(t) = make_float2(t0 * xc.x, t1 * xc.y);
            *reinterpret_cast<float2*>(t + p.d) = make_float2(-(t0 * xs.x), -(t1 * xs.y));
          }
        }
      }
      asm volatile("fence.proxy.async.global;" ::: "memory");
      mbar_arrive(ts_ready);
      PHASE_MARK(6, kStore);
    }

    // 2. The recompute: h_l = relu(acc + b_l) to the tile and the scratch,
    // relu' as bits; layer 0's input to the x scratch.
    for (int l = 0; l < p.depth; ++l) {
      const bool sk = l == p.skip && l > 0;
      if (l == 0)
        product_bwd<true>(acc, part, c, 2, 3,
                          cw == 0 ? p.xs + static_cast<size_t>(row0 + ra) * kInLd : nullptr, p.d);
      else
        product_bwd<false>(acc, part, c, sk ? 3 : 1, sk ? 6 : 0);
      PHASE_MARK(1, kProd);
      const float* bl = p.b + l * kWidth + 128 * cw + 2 * q;
      uint2 mk = make_uint2(0u, 0u);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bl + 8 * j));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          acc[i] = fmaxf(acc[i] + bb.x, 0.f);
          acc[i + 1] = fmaxf(acc[i + 1] + bb.y, 0.f);
          const uint32_t bits = (acc[i] > 0.f ? 1u : 0u) | (acc[i + 1] > 0.f ? 2u : 0u);
          if (i < 32) mk.x |= bits << i; else mk.y |= bits << (i - 32);
        }
      }
      if (l + 1 < p.depth)
        masks[l * kCons + ctid] = mk;
      else
        mlast = mk;
      if (!H0 || l + 1 < p.depth) to_act(acc, &m.hs, l);  // H0: y stays here
      PHASE_MARK(1, kScal);
    }

    // 3. DG: the inner chain: s_{L-1} = relu'(h_{L-1}) wd, s_{l-1} =
    // relu'(h_{l-1}) (s_l Wa_l), to the scratch.
    if constexpr (DG) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(p.wd + 128 * cw + 8 * j + 2 * q));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          acc[i] = bit(mlast, i) ? w.x : 0.f;
          acc[i + 1] = bit(mlast, i + 1) ? w.y : 0.f;
        }
      }
      to_act(acc, &m.ss, p.depth - 1);
      PHASE_MARK(3, kScal);
      for (int l = p.depth - 1; l > 0; --l) {
        product_bwd<false>(acc, part, c, 1, 0);
        PHASE_MARK(3, kProd);
        relu_mask(acc, masks[(l - 1) * kCons + ctid]);
        to_act(acc, &m.ss, l - 1);
        PHASE_MARK(3, kScal);
      }
    }

    // 4. The head backward: zeta_{L-1} = relu'(h_{L-1}) (cbar wc + sbar wd),
    // cbar's slices by TMA; H0: relu'(h_{L-1}) (sbar wd), no product.
    if constexpr (!H0) {
      product_bwd<false>(acc, part, c, 1, 1);
      PHASE_MARK(4, kProd);
    }
    {
      float sb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + ra + 8 * h;
        sb[h] = row < p.n ? __ldg(p.sbar + row) : 0.f;
      }
      if constexpr (H0) {
        // dwd's share of the tile from y in acc (never stored): each
        // thread's two rows, the 8 lanes of its columns (xor 4, 8, 16),
        // the 4 warps of its warpgroup through the input slots (free: the
        // reverse reads no input), in that order.
        float* red = reinterpret_cast<float*>(slots);  // [4 warps][256]
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = fmaf(sb[1], acc[4 * j + 2 + e], sb[0] * acc[4 * j + e]);
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) red[cwarp * kWidth + 128 * cw + 8 * j + 2 * q + e] = v;
          }
        cons_sync();
        p.dwd[blockIdx.x * kWidth + ctid] =
            red[ctid] + red[kWidth + ctid] + red[2 * kWidth + ctid] + red[3 * kWidth + ctid];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(p.wd + 128 * cw + 8 * j + 2 * q));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          if constexpr (H0) {
            acc[i] = bit(mlast, i) ? sb[h] * w.x : 0.f;
            acc[i + 1] = bit(mlast, i + 1) ? sb[h] * w.y : 0.f;
          } else {
            acc[i] = bit(mlast, i) ? acc[i] + sb[h] * w.x : 0.f;
            acc[i + 1] = bit(mlast, i + 1) ? acc[i + 1] + sb[h] * w.y : 0.f;
          }
        }
      }
    }
    to_act(acc, &m.zs, p.depth - 1);
    PHASE_MARK(4, kScal);

    // 5. The first-order reverse: zeta_{l-1} = relu'(h_{l-1}) (zeta_l Wa_l).
    for (int l = p.depth - 1; l > 0; --l) {
      product_bwd<false>(acc, part, c, 1, 0);
      PHASE_MARK(5, kProd);
      relu_mask(acc, masks[(l - 1) * kCons + ctid]);
      to_act(acc, &m.zs, l - 1);
      PHASE_MARK(5, kScal);
    }

    // 6. DG: the tangent chain: p_l = relu'(h_l) ([p_{l-1} | ts] W_l), ts's
    // slices by TMA from the scratch; every p_l to the scratch (p_{L-1} for
    // dwd's column sums).
    if constexpr (DG) {
      for (int l = 0; l < p.depth; ++l) {
        const bool sk = l == p.skip && l > 0;
        product_bwd<false>(acc, part, c, l == 0 ? 2 : (sk ? 3 : 1), l == 0 ? 3 : (sk ? 6 : 0));
        PHASE_MARK(6, kProd);
        relu_mask(acc, l + 1 < p.depth ? masks[l * kCons + ctid] : mlast);
        to_act(acc, &m.ps, l);
        PHASE_MARK(6, kScal);
      }
    }
    if (ctid == 0) bulk_wait();  // the last stores are written
  }
}

template <bool DG, bool H0 = false>
int launch_bwd(const BwdParams& p, const BwdMaps& m, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes(p.depth);
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_tf32_kernel<DG, H0>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  trunk_bwd_tf32_kernel<DG, H0><<<p.rp / kRows, kWgThreads, smem, s>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned8(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 7) == 0; }

}  // namespace wtf

// The per-tile backward of the wide-input spatial trunk in f32 (see the top
// of this file): n rows (rp, the scratch's rows, a multiple of 64 and at
// least n) of the segments x0, x1 [n][d] (d a multiple of 4, at most 256;
// contiguous, 16-byte aligned), depth layers of width 256 with the skip at
// layer `skip`, B's parts bh, bl [np * 256][256] (`refnerf_wide_tf32_split`
// of `fused_mlp.tf32_bwd_panel_index`'s panels), tp's th, tl [256][32] (the
// same split of `fused_mlp.tf32_tp_index`; with ubar), the biases b
// [depth][256], the density head wd [256], the cotangents sbar [n], cbar
// [n][256] and, for the second-order pass, ubar [n][nb] (nb <= 32; null:
// first order); out the scratch regions hs, zs (and with ubar ss, ps)
// [depth][rp][256], xs (and ts) [rp][512], all f32. Returns the
// cudaError_t of the launch; allocates nothing and does not synchronise.
extern "C" int refnerf_wide_tf32_k4(int n, int rp, int d, int depth, int skip, int nb,
                                    const void* x0, const void* x1, const void* bh,
                                    const void* bl, int np, const void* th, const void* tl,
                                    const void* b, const void* wd, const void* sbar,
                                    const void* cbar, const void* ubar, void* hs, void* zs,
                                    void* ss, void* ps, void* xs, void* ts, void* stream) {
  using namespace wtf;
  const bool dg = ubar != nullptr;
  if (n <= 0 || rp < n || rp % kRows || d <= 0 || d > kWidth || d % 4 || depth < 2 ||
      depth > kMaxDepth || np != bwd_panels(depth, skip, dg) || !x0 || !x1 || !bh || !bl || !b ||
      !wd || !sbar || !cbar || !hs || !zs || !xs || !aligned16(x0) || !aligned16(x1) ||
      !aligned16(bh) || !aligned16(bl) || !aligned16(cbar) || !aligned8(b) || !aligned8(wd) ||
      !aligned16(hs) || !aligned16(zs) || !aligned8(xs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dg && (nb <= 0 || nb > kMaxNb || !th || !tl || !ss || !ps || !ts || !aligned16(th) ||
             !aligned16(tl) || !aligned16(ss) || !aligned16(ps) || !aligned16(ts)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bwd_smem_bytes(depth) > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  BwdMaps m;
  memset(&m, 0, sizeof(m));
  bool ok = make_map_f32(&m.bh, bh, kWidth, np * kWidth, kWidth, kWidth) &&
            make_map_f32(&m.bl, bl, kWidth, np * kWidth, kWidth, kWidth) &&
            make_map_f32(&m.x0, x0, d, n, d, kRows) && make_map_f32(&m.x1, x1, d, n, d, kRows) &&
            make_map_f32(&m.cbar, cbar, kWidth, n, kWidth, kRows);
  const int lrows = depth * rp;
  ok = ok && make_map_f32(&m.hs, hs, kWidth, lrows, kWidth, kRows) &&
       make_map_f32(&m.zs, zs, kWidth, lrows, kWidth, kRows);
  if (dg)
    ok = ok && make_map_f32(&m.ts, ts, kInLd, rp, kInLd, kRows) &&
         make_map_f32(&m.th, th, kFK, kWidth, kFK, kWidth) &&
         make_map_f32(&m.tl, tl, kFK, kWidth, kFK, kWidth) &&
         make_map_f32(&m.ss, ss, kWidth, lrows, kWidth, kRows) &&
         make_map_f32(&m.ps, ps, kWidth, lrows, kWidth, kRows);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{static_cast<const float*>(x0), static_cast<const float*>(x1), d, n, rp, depth,
                    skip, nb, static_cast<const float*>(b), static_cast<const float*>(wd),
                    static_cast<const float*>(sbar), static_cast<const float*>(ubar),
                    static_cast<float*>(hs), static_cast<float*>(zs), static_cast<float*>(ss),
                    static_cast<float*>(ps), static_cast<float*>(xs), static_cast<float*>(ts)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dg ? launch_bwd<true>(p, m, s) : launch_bwd<false>(p, m, s);
}

// The first-order backward of the proposal trunk in f32 (the density head
// alone, H0): as refnerf_wide_tf32_k4 without cbar, ubar and their
// outputs, its panels `fused_mlp.tf32_bwd_panel_index` without the head's
// (np = bwd_panels(depth, skip, false, false)); out the scratch regions hs,
// zs [depth][rp][256] (hs of layers 0 to depth - 2: y is not stored) and
// xs [rp][512], and dwd [rp / 64][256], each 64-row tile's sum of sbar y.
extern "C" int refnerf_wide_tf32_k4h0(int n, int rp, int d, int depth, int skip,
                                      const void* x0, const void* x1, const void* bh,
                                      const void* bl, int np, const void* b, const void* wd,
                                      const void* sbar, void* hs, void* zs, void* xs, void* dwd,
                                      void* stream) {
  using namespace wtf;
  if (n <= 0 || rp < n || rp % kRows || d <= 0 || d > kWidth || d % 4 || depth < 2 ||
      depth > kMaxDepth || np != bwd_panels(depth, skip, false, false) || !x0 || !x1 || !bh ||
      !bl || !b || !wd || !sbar || !hs || !zs || !xs || !dwd || !aligned16(x0) || !aligned16(x1) ||
      !aligned16(bh) || !aligned16(bl) || !aligned8(b) || !aligned8(wd) || !aligned16(hs) ||
      !aligned16(zs) || !aligned8(xs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bwd_smem_bytes(depth) > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  BwdMaps m;
  memset(&m, 0, sizeof(m));
  const int lrows = depth * rp;
  if (!make_map_f32(&m.bh, bh, kWidth, np * kWidth, kWidth, kWidth) ||
      !make_map_f32(&m.bl, bl, kWidth, np * kWidth, kWidth, kWidth) ||
      !make_map_f32(&m.x0, x0, d, n, d, kRows) || !make_map_f32(&m.x1, x1, d, n, d, kRows) ||
      !make_map_f32(&m.hs, hs, kWidth, lrows, kWidth, kRows) ||
      !make_map_f32(&m.zs, zs, kWidth, lrows, kWidth, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{static_cast<const float*>(x0), static_cast<const float*>(x1), d, n, rp, depth,
                    skip, 0, static_cast<const float*>(b), static_cast<const float*>(wd),
                    static_cast<const float*>(sbar), nullptr, static_cast<float*>(hs),
                    static_cast<float*>(zs), nullptr, nullptr, static_cast<float*>(xs), nullptr,
                    static_cast<float*>(dwd)};
  return launch_bwd<false, true>(p, m, static_cast<cudaStream_t>(stream));
}

// The bf16 density-gradient forward (K3) of the wide-input spatial trunk on
// Hopper's tensor cores: one bf16 pass of wgmma fed by TMA for the layers,
// the bottleneck and the chain, the fold onto the lifted means as three
// TF32 passes on the u_x accumulators.
//
// Replaces, for the compute dtype bfloat16 on the JAX package's default
// spatial trunk (8 x 256 on two IPE segments of 192 < d <= 256 columns each,
// 504 at the defaults, the skip at one layer, the density head and the
// 256-wide compute-dtype head, no f32 heads), the forward Pallas kernel
// `_fwd_kernel` (refnerf_tpu/ops/pallas/fused_mlp.py :612-666) with
// `density_grad`: the layers h_l = relu(acc + b_l), sigma = y wd, the
// bottleneck y wc^T + bc, the inner chain `_inner_chain` (:589-609) s_{L-1} =
// relu'(h_{L-1}) wd, s_{l-1} = relu'(h_{l-1}) (s_l Wa_l), u_x = s_skip
// Wx_skip + s_0 Wx_0 and its fold onto the lifted means (:651-662), u_m = xc
// u_xs - xs u_xc, u = u_m S. trunk_fwd_tma.cu's `fwd_wide<256, 1>` ran it
// before (one 64-row tile a CTA, the fold on the FMA pipes) and keeps the
// other wide-input shapes. The arithmetic and bf16 roundings are
// trunk_fwd.cu's (trunk_fwd_tma.cu:14-18): each f32 sum rounded to bf16
// before the bf16 bias add, then ReLU; sigma on f32(y); the bottleneck
// cdt(y wc^T) + cdt(bc); the chain q = cdt(s_l Wa_l); u_x in f32.
//
// Bound at 524,288 rows on an H100 (1.572 TFLOP, chip_smoke.py
// `trunk_flops`): 1.59 ms at 989 TFLOP/s. Every 128-row tile reads each
// weight panel once: ~2.9 MB of bf16 weights and 256 KB of the fold's TF32
// parts a tile, ~13 GB from L2 for the call (the 64-row design read twice
// that). The parent's per-phase split (tools/bwd_phases.py, PERF.md
// section 6) put 3.9 of its 8.8 ms in the fold's partner loads and FMA
// passes and 2.6 ms in the products.
//
// The design (trunk_wide_tf32.cu's shape, with rows split between the
// consumers instead of columns):
//  - A CTA is persistent (one an SM) and walks 128-row tiles: two consumer
//    warpgroups and a producer warpgroup (its first thread issues the TMA
//    loads; setmaxnreg 40). Consumer warpgroup c owns rows [64 c, 64 c +
//    64) of the tile and all 256 columns of every product, as two halves of
//    128 columns (wgmma m64n128k16, 64 accumulators a thread): the two
//    consumers share every weight slice of the ring and nothing else
//    (barriers are a warpgroup's own). Waiting on the same stages, they run
//    in step, so their epilogues leave the tensor cores idle (H29).
//  - The weights come by TMA from the forward pack `w`, `wc` and, for the
//    chain, the transposed pack `wt`, in [128][64] slices (one half's 64 K
//    columns) through a ring of four 16 KB stages, in the order the tile
//    runs them; the fold's TF32 parts ([32][32] f32 boxes of hi and lo, 8 KB)
//    pass through the same ring.
//  - A comes from shared memory: each warpgroup's [64][256] activation tile
//    (wgmma's 128-byte-swizzled K-major layout), or its input chunks of 128
//    columns, 8-byte cp.asyncs straight into that layout (`wide_chunk`):
//    all four of layer 0 at once (two buffers and the activation tile, free
//    until its epilogue; its products start once the first two have
//    landed), the skip layer's two at a time ([x0 x1 | h | x2 x3] for the
//    first half, [x2 x3 | h | x0 x1] for the second: each pair lands
//    during the other's products).
//  - The epilogues work in registers: a half's bias, ReLU and rounding on
//    bf16 pairs, relu' as bits (128 a thread and layer, in shared memory
//    but the last layer's), the first half kept as packed bf16 until the
//    second half's product has read the tile; sigma's partial dot products
//    summed over the row's quad; the bottleneck staged in the activation
//    tile and stored 16 bytes a thread, a warp a row.
//  - u_x is made per 128 input columns (4 products of K = 256 at the skip
//    layer, 4 at layer 0) and each is folded at once by one more product
//    on the tensor cores: its accumulators, scaled by the partner segment's
//    values, are the A fragments of a TF32 m64n32k8 product (three passes,
//    each chunk's 128-deep sum added into u's in f32, H26) against the fold
//    panel (S^T of those columns, K permuted within every 8:
//    `fused_mlp.bf16_fold_panel`). The partner values (xc for a sin
//    column, -xs for a cos one) are loaded into registers from device
//    memory just before the u_x product: no staging, no waits or barriers
//    for them; u's 16 sums a thread stay in registers.
//  - Reruns are bit-identical: every sum runs in a fixed order.
// One CTA an SM (226,368 B of shared memory at depth 8; `kernel_smem` in
// fused_mlp.py mirrors `smem_bytes`).

#define PHASE_SYNC() wg_bar(threadIdx.x >> 7)  // closes a stamped segment: a warpgroup's own
#include "wide_tf32.cuh"

namespace wbf {

constexpr int kTile = 128;               // rows of a CTA's tile
constexpr int kSl = 128 * 64 * 2;        // a [128][64] bf16 weight slice: 16 KB
constexpr int kFoldSl = 2 * 32 * 32 * 4;  // a fold slice's hi and lo [32][32] f32
constexpr int kRing = 4;                 // stages of the ring
constexpr int kChunkB = kRows * 128 * 2;  // a warpgroup's [64][128] input chunk
constexpr int kActB = kRows * 256 * 2;    // a warpgroup's [64][256] activation tile
constexpr int kCtaThreads = kCons + 128;
constexpr int kProdRegs = 40, kConsRegs = 232;
constexpr int kNch = 4;  // 128-column chunks of the input (kin <= 512)

// Dynamic shared memory of a launch: 1 KB to align the swizzled tiles, the
// ring, the two activation tiles, the two warpgroups' two input buffers,
// the relu' bits of layers 0 to depth - 2, the mbarriers.
inline size_t smem_bytes(int depth) {
  return 1024 + static_cast<size_t>(kRing) * kSl + 2 * kActB + 4 * kChunkB +
         16 * static_cast<size_t>(depth - 1) * kCons + 8 * 2 * kRing;
}

struct Params {
  const bf16* x0;  // [n][d]: the sin segment
  const bf16* x1;  // [n][d]: the cos segment
  int d, n, depth, skip, nb, kin;
  const bf16* b;    // [depth][256]
  const float* wd;  // [256]
  const bf16* bc;   // [256]
  float* sig;       // [n]
  bf16* cout;       // [n][256]
  float* u;         // [n][nb]
};

struct Maps {
  CUtensorMap w[kMaxDepth];   // layer l of `w`: [256][K_l], boxes [128][64]
  CUtensorMap wt[kMaxDepth];  // layer l of `wt`: [K_l][256], boxes [128][64]
  CUtensorMap wc;             // [256][256], boxes [128][64]
  CUtensorMap fh, fl;         // the fold panel's parts [4 * 32][128], boxes [32][32]
};

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// A consumer warpgroup's own barrier (ids 2, 3).
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

// acc (+)= A B^T over the ring's next 4 slices: A's slice s the [64][64]
// block at a + s kBlk (the warpgroup's rows), B [128][64]; with acc_in the
// first slice keeps the accumulators. Consumer warps only.
__device__ __forceinline__ void prod4(float (&acc)[64], Ring& r, uint32_t a, int acc_in,
                                      int lane) {
  int prev = 0;
  wg_fence();
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t b = r.base + r.stage * kSl;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma128<0, 0>(acc, sw128_desc(a + s * kBlk + 32 * kk, 16, 1024),
                     sw128_desc(b + 32 * kk, 16, 1024), s | kk | acc_in);
    wg_commit();
    if (s > 0) {
      wg_wait<1>();
      if (lane == 0) mbar_arrive(r.empty + 8 * prev);
    }
    prev = r.stage;
    r.advance();
  }
  wg_wait<0>();
  if (lane == 0) mbar_arrive(r.empty + 8 * prev);
  acc_fence(acc);
}

// The partner values of input chunk ch (columns c in [128 ch, 128 ch + 128)
// of [x0 | x1]) that a thread's u_x accumulators meet in the fold: xc =
// x1[r][c] for a sin column c < d, xs = x0[r][c - d] for a cos one, zeros
// past the segments and past `rows`; xv[2 j + h] the pair of columns 128 ch
// + 8 j + 2 q, + 1 of row ra + 8 h (one segment's, d being even), read
// from device memory just before the u_x product. The product's first
// wgmma fence waits for the loads; issued within the product they cost
// more (PERF.md section 6, H29).
__device__ __forceinline__ void partners(uint32_t (&xv)[32], const bf16* x0, const bf16* x1,
                                         int d, int ch, int row0, int rows, int ra, int q) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int g = 128 * ch + 8 * j + 2 * q;
    const bf16* src = g < d ? x1 + g : x0 + (g - d);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      xv[2 * j + h] =
          g < 2 * d && r < rows
              ? __ldg(reinterpret_cast<const unsigned int*>(src + static_cast<size_t>(row0 + r) * d))
              : 0u;
    }
  }
}

// u_x of input chunk ch (acc: column 128 ch + 8 j + 2 q + e of rows ra + 8 h
// in acc[4 j + 2 h + e]) folded into u (fu, m64n32: basis vector 8 jj + 2 q
// + e of rows ra + 8 h in fu[4 jj + 2 h + e]) as one more product on the
// tensor cores: u_m = partner * u_x (xv, `partners`; + for a sin column, -
// for a cos one) in the accumulators' layout is the A fragments' of K = the
// chunk's 128 columns (slots q, q + 4 of step j: columns 8 j + 2 q, + 1),
// against the fold panel's rows 32 ch .. + 31 from the ring, 4 slices of
// 32, three TF32 passes, each step's A parts in one of two register sets.
// The chunk's 16 steps accumulate into one set, added into fu in f32 at the
// end (H26's slice sums at the chunk's 128). A slice's stage is released
// once its last step's products are done.
__device__ __forceinline__ void fold(const float (&acc)[64], const uint32_t (&xv)[32],
                                     float (&fu)[16], Ring& r, int ch, int d, int q, int lane) {
  uint32_t hs[2][4], ls[2][4];
  float part[16];
  int prev = -1;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t bh = r.base + r.stage * kSl, bl = bh + kFoldSl / 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = 4 * kb + kk;
      if (j > 1) {
        wg_wait<1>();  // the step two back is done: its register set is free
        if (kk == 1 && lane == 0) mbar_arrive(r.empty + 8 * prev);
      }
      uint32_t(&hi)[4] = hs[kk & 1];
      uint32_t(&lo)[4] = ls[kk & 1];
      const float sg = 128 * ch + 8 * j + 2 * q < d ? 1.f : -1.f;
      const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&xv[2 * j]);
      const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&xv[2 * j + 1]);
      wtf::split_tf32(sg * to_f(p0.x) * acc[4 * j], hi[0], lo[0]);
      wtf::split_tf32(sg * to_f(p1.x) * acc[4 * j + 2], hi[1], lo[1]);
      wtf::split_tf32(sg * to_f(p0.y) * acc[4 * j + 1], hi[2], lo[2]);
      wtf::split_tf32(sg * to_f(p1.y) * acc[4 * j + 3], hi[3], lo[3]);
      wg_fence();
      wtf::wgmma32_tf32(part, lo, sw128_desc(bh + 32 * kk, 16, 1024), j);
      wtf::wgmma32_tf32(part, hi, sw128_desc(bl + 32 * kk, 16, 1024), 1);
      wtf::wgmma32_tf32(part, hi, sw128_desc(bh + 32 * kk, 16, 1024), 1);
      wg_commit();
    }
    prev = r.stage;
    r.advance();
  }
  wg_wait<0>();
  if (lane == 0) mbar_arrive(r.empty + 8 * prev);
#pragma unroll
  for (int e = 0; e < 16; ++e) asm volatile("" : "+f"(part[e])::"memory");
#pragma unroll
  for (int e = 0; e < 16; ++e) fu[e] += part[e];
}

// The 128-row tiles of the call, persistent CTAs. Threads 0-255: the
// consumers; 256-383: the producer warpgroup (thread 256 walks the slices).
__global__ void __launch_bounds__(kCtaThreads, 1)
    trunk_fwd_bf16_kernel(const __grid_constant__ Params p, const __grid_constant__ Maps m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* act0 = smem + kRing * kSl;  // 2 x [64][256]: h_l, then s_l
  unsigned char* buf0 = act0 + 2 * kActB;    // 2 x 2 x [64][128]: input chunks, partners
  uint4* masks = reinterpret_cast<uint4*>(buf0 + 4 * kChunkB);  // [depth - 1][256]
  const uint32_t full = smem_u32(masks + (p.depth - 1) * kCons), empty = full + 8 * kRing;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int tiles = (p.n + kTile - 1) / kTile;

  if (warp >= kCons / 32) {
    reg_dealloc<kProdRegs>();
    if (tid == kCons) {
      // The tile's order (the consumers' below).
      Ring r{smem_u32(smem), full, empty, kRing, 0, 0u};
      auto slices = [&](const CUtensorMap* map, int k0, int row) {
        for (int s = 0; s < 4; ++s) {
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          mbar_expect_tx(r.full + 8 * r.stage, kSl);
          tma_load(r.base + r.stage * kSl, map, r.full + 8 * r.stage, k0 + 64 * s, row);
          r.advance();
        }
      };
      auto fold_panel = [&](int ch) {
        for (int kb = 0; kb < 4; ++kb) {
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kSl;
          mbar_expect_tx(f, kFoldSl);
          tma_load(dst, &m.fh, f, 32 * kb, 32 * ch);
          tma_load(dst + kFoldSl / 2, &m.fl, f, 32 * kb, 32 * ch);
          r.advance();
        }
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int l = 0; l < p.depth; ++l)
          for (int nh = 0; nh < 2; ++nh) {
            const CUtensorMap* w = &m.w[l];
            if (l == 0) {
              slices(w, 0, 128 * nh);
              slices(w, 256, 128 * nh);
            } else if (l == p.skip) {  // [x_a | h | x_b]
              slices(w, kW + (nh == 0 ? 0 : 256), 128 * nh);
              slices(w, 0, 128 * nh);
              slices(w, kW + (nh == 0 ? 256 : 0), 128 * nh);
            } else {
              slices(w, 0, 128 * nh);
            }
          }
        for (int nh = 0; nh < 2; ++nh) slices(&m.wc, 0, 128 * nh);
        for (int l = p.depth - 1; l >= 0; --l) {
          if (l == 0 || l == p.skip)
            for (int ch = 0; ch < kNch; ++ch) {
              slices(&m.wt[l], 0, (l == 0 ? 0 : 256) + 128 * ch);
              fold_panel(ch);
            }
          if (l > 0)
            for (int nh = 0; nh < 2; ++nh) slices(&m.wt[l], 0, 128 * nh);
        }
      }
    }
    return;
  }

  reg_alloc<kConsRegs>();
  PHASE_START;
  const int wg = tid >> 7, t = tid & 127;
  const int g = lane >> 2, q = lane & 3, ra = 16 * (warp & 3) + g;
  unsigned char* act = act0 + wg * kActB;
  unsigned char* buf = buf0 + wg * 2 * kChunkB;
  const uint32_t act_s = smem_u32(act), buf_s = smem_u32(buf);
  Ring r{smem_u32(smem), full, empty, kRing, 0, 0u};
  float acc[64], fu[16];
  uint32_t h0[32];
  uint4 mlast = make_uint4(0u, 0u, 0u, 0u);  // relu' of the last layer

  // Input chunk c of the warpgroup's rows to slot k (0, 1: the buffers; 2,
  // 3: the activation tile).
  auto chunk = [&](int c, int k, int row0, int rows) {
    wide_chunk<128>(k < 2 ? buf + k * kChunkB : act + (k - 2) * kChunkB, p.x0, p.d, p.x1, p.d,
                    128 * c, 128, row0, rows, t, 128);
  };
  auto landed = [&]() {  // the warpgroup's cp.asyncs, for its products
    cp_async_wait<0>();
    fence_async_smem();
    wg_bar(wg);
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTile + kRows * wg, rows = max(0, min(kRows, p.n - row0));
    // The warpgroup's input, all four chunks at once (the last tile's reads
    // of the buffers and its tile ended before barriers), the products
    // starting once the first two have landed.
    for (int c = 0; c < kNch; ++c) {
      chunk(c, c, row0, rows);
      if (c & 1) cp_async_commit();  // chunks 0, 1 a group, 2, 3 the next
    }
    cp_async_wait<1>();  // layer 0's first half of its input
    fence_async_smem();
    wg_bar(wg);
    PHASE_MARK(0, kScal);

    // 1. The layers, each in two halves of 128 columns; the first half's
    // values wait in h0 until the second half's product has read the tile.
    float s[2] = {0.f, 0.f};  // sigma's partial sums, rows ra, ra + 8
    for (int l = 0; l < p.depth; ++l) {
      uint4 mk = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        if (l == 0) {
          prod4(acc, r, buf_s, 0, lane);
          if (nh == 0) landed();  // chunks 2, 3 landed during the first four slices
          prod4(acc, r, act_s, 1, lane);
        } else if (l == p.skip) {  // [x_a | h | x_b]: x_b lands during h's product
          if (nh == 0) landed();  // the first pair, issued after layer 0
          prod4(acc, r, buf_s, 0, lane);
          wg_bar(wg);
          for (int c = 0; c < 2; ++c) chunk(nh == 0 ? 2 + c : c, c, row0, rows);
          cp_async_commit();
          prod4(acc, r, act_s, 1, lane);
          landed();
          prod4(acc, r, buf_s, 1, lane);
        } else {
          prod4(acc, r, act_s, 0, lane);
        }
        PHASE_MARK(1, kProd);
        const bf16* bl = p.b + l * kW + 128 * nh + 2 * q;
        uint32_t bits[2] = {0u, 0u};
        if (nh == 1) wg_bar(wg);  // every product has read the tile
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bl + 8 * j);
          const float2 w = l + 1 == p.depth
                               ? __ldg(reinterpret_cast<const float2*>(p.wd + 128 * nh + 8 * j +
                                                                       2 * q))
                               : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            // h = relu(cdt(cdt(acc) + b)) on a bf16 pair.
            const uint32_t v = bits2(__hmax2(
                __hadd2(__floats2bfloat162_rn(acc[i], acc[i + 1]), bb), __float2bfloat162_rn(0.f)));
            bits[i >> 5] |= ((v & 0x7fffu) != 0u ? 1u : 0u) << (i & 31);
            bits[i >> 5] |= ((v & 0x7fff0000u) != 0u ? 1u : 0u) << ((i + 1) & 31);
            if (nh == 0) h0[2 * j + h] = v;
            if (l + 1 == p.depth)  // sigma = f32(y) wd
              s[h] = fmaf(__uint_as_float(v & 0xffff0000u), w.y,
                          fmaf(__uint_as_float(v << 16), w.x, s[h]));
            if (nh == 1)
              *reinterpret_cast<uint32_t*>(act + sw_off(ra + 8 * h, 128 + 8 * j + 2 * q)) = v;
          }
        }
        if (nh == 0) {
          mk.x = bits[0];
          mk.y = bits[1];
        } else {
          mk.z = bits[0];
          mk.w = bits[1];
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint32_t*>(act + sw_off(ra + 8 * h, 8 * j + 2 * q)) = h0[2 * j + h];
        }
      }
      if (l + 1 < p.depth)
        masks[l * kCons + tid] = mk;
      else
        mlast = mk;
      fence_async_smem();
      if (l == 0 && p.skip > 0) {  // the skip layer's first pair, into the free buffers
        for (int c = 0; c < 2; ++c) chunk(c, c, row0, rows);
        cp_async_commit();
      }
      wg_bar(wg);
      PHASE_MARK(1, kScal);
    }
    // sigma from the quad's partial sums.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      if (q == 0 && ra + 8 * h < rows) p.sig[row0 + ra + 8 * h] = s[h];
    }

    // 2. The bottleneck cdt(y wc^T) + cdt(bc) from its accumulators: the
    // first half's values wait in h0, then both halves go through the
    // activation tile (free once the second half's product has read y) and
    // leave 16 bytes of a row a store, a warp a row.
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      prod4(acc, r, act_s, 0, lane);
      PHASE_MARK(2, kProd);
      if (nh == 1) wg_bar(wg);  // every product has read y
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 128 * nh + 8 * j + 2 * q;
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(p.bc + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const uint32_t v = bits2(__floats2bfloat162_rn(bias_add<bf16>(acc[i], bb.x),
                                                         bias_add<bf16>(acc[i + 1], bb.y)));
          if (nh == 0)
            h0[2 * j + h] = v;
          else
            *reinterpret_cast<uint32_t*>(act + sw_off(ra + 8 * h, c)) = v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(act + sw_off(ra + 8 * h, 8 * j + 2 * q)) = h0[2 * j + h];
    wg_bar(wg);
    for (int i = t; i < kRows * 32; i += 128) {
      const int row = i >> 5, c = 8 * (i & 31);
      if (row < rows)
        *reinterpret_cast<uint4*>(p.cout + static_cast<size_t>(row0 + row) * kW + c) =
            *reinterpret_cast<const uint4*>(act + sw_off(row, c));
    }
    PHASE_MARK(2, kStore);

    // 3. The chain: s_{L-1} = relu'(h_{L-1}) cdt(wd), then s_{l-1} =
    // relu'(h_{l-1}) cdt(s_l Wa_l); u_x of the skip layer (before its s
    // product) and of layer 0 a chunk at a time, each folded into fu.
#pragma unroll
    for (int e = 0; e < 16; ++e) fu[e] = 0.f;
    wg_bar(wg);  // the bottleneck's values have left the tile
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      const uint32_t b0 = nh ? mlast.z : mlast.x, b1 = nh ? mlast.w : mlast.y;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 128 * nh + 8 * j + 2 * q;
        const float q0 = round_t<bf16>(p.wd[c]), q1 = round_t<bf16>(p.wd[c + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const uint32_t b = ((i < 32 ? b0 >> i : b1 >> (i - 32)) & 3u);
          *reinterpret_cast<uint32_t*>(act + sw_off(ra + 8 * h, c)) =
              bits2(__floats2bfloat162_rn(b & 1u ? q0 : 0.f, b & 2u ? q1 : 0.f));
        }
      }
    }
    fence_async_smem();
    wg_bar(wg);
    PHASE_MARK(3, kScal);
    for (int l = p.depth - 1; l >= 0; --l) {
      if (l == 0 || l == p.skip) {
        // u_x 128 input columns a product, each one's partners loaded while
        // it runs, then folded.
        for (int ch = 0; ch < kNch; ++ch) {
          uint32_t xv[32];
          partners(xv, p.x0, p.x1, p.d, ch, row0, rows, ra, q);
          prod4(acc, r, act_s, 0, lane);
          PHASE_MARK(3, kProd);
          fold(acc, xv, fu, r, ch, p.d, q, lane);
          PHASE_MARK(6, kProd);
        }
      }
      if (l == 0) break;
      const uint4 mk = masks[(l - 1) * kCons + tid];
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        prod4(acc, r, act_s, 0, lane);
        PHASE_MARK(3, kProd);
        const uint32_t b0 = nh ? mk.z : mk.x, b1 = nh ? mk.w : mk.y;
        if (nh == 1) wg_bar(wg);  // every product has read s_l
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // cdt(acc) on bf16 pairs, masked by the two relu' bits.
            const int i = 4 * j + 2 * h;
            const uint32_t b = ((i < 32 ? b0 >> i : b1 >> (i - 32)) & 3u);
            const uint32_t keep = ((0u - (b & 1u)) & 0xffffu) | ((0u - (b >> 1)) & 0xffff0000u);
            const uint32_t v = bits2(__floats2bfloat162_rn(acc[i], acc[i + 1])) & keep;
            if (nh == 0)
              h0[2 * j + h] = v;
            else
              *reinterpret_cast<uint32_t*>(act + sw_off(ra + 8 * h, 128 + 8 * j + 2 * q)) = v;
          }
        if (nh == 1)
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint32_t*>(act + sw_off(ra + 8 * h, 8 * j + 2 * q)) = h0[2 * j + h];
      }
      fence_async_smem();
      wg_bar(wg);
      PHASE_MARK(3, kScal);
    }
    // u from the thread's sums.
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = ra + 8 * h, j = 8 * jj + 2 * q + e;
          if (row < rows && j < p.nb)
            p.u[static_cast<size_t>(row0 + row) * p.nb + j] = fu[4 * jj + 2 * h + e];
        }
    wg_bar(wg);  // every product has read s_0
    PHASE_MARK(3, kStore);
  }
}

// y[i] = hi and lo, the TF32 parts of src[idx[i]] (0 for idx < 0).
__global__ void __launch_bounds__(256) fold_split_kernel(int n, const int* idx, const float* src,
                                                         float* hi, float* lo) {
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    const int k = idx[i];
    uint32_t h, l;
    wtf::split_tf32(k < 0 ? 0.f : src[k], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

}  // namespace wbf

// The fold panel's TF32 parts: hi[i], lo[i] of fold[idx[i]] (0 for idx <
// 0), for i < n: `fused_mlp.bf16_fold_panel`'s layout, split once a call.
extern "C" int refnerf_wide_bf16_fold(int n, const void* idx, const void* fold, void* hi,
                                      void* lo, void* stream) {
  if (n <= 0 || !idx || !fold || !hi || !lo) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  wbf::fold_split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(idx), static_cast<const float*>(fold), static_cast<float*>(hi),
      static_cast<float*>(lo));
  return static_cast<int>(cudaGetLastError());
}

// K3 of the wide-input spatial trunk in bf16 (see the top of this file): n
// rows of the segments x0, x1 [n][d] (192 < d <= 256, a multiple of 4;
// contiguous, 16-byte aligned), depth layers of width 256 with the skip at
// layer 0 < skip < depth, the packs w and wt (`fused_mlp.pack_trunk`: kin =
// 2 d rounded up to 32 input columns) and wc [256][256], the fold panel's
// TF32 parts fh, fl [4 * 32][128] (`refnerf_wide_bf16_fold`), the biases b
// [depth][256] and bc [256] bf16, the density head wd [256] f32; out sigma
// [n] f32, the bottleneck [n][256] bf16, u [n][nb] f32 (nb <= 32). Returns
// the cudaError_t of the launch; allocates nothing and does not
// synchronise.
extern "C" int refnerf_wide_bf16_k3(int n, int d, int depth, int skip, int nb, int kin,
                                    const void* x0, const void* x1, const void* w,
                                    const void* wt, const void* wc, const void* fh,
                                    const void* fl, const void* b, const void* wd, const void* bc,
                                    void* sig, void* cout, void* u, void* stream) {
  using namespace wbf;
  const auto a16 = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  const auto a4 = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 3) == 0; };
  if (n <= 0 || d <= 192 || d > 256 || d % 4 || kin != (2 * d + 31) / 32 * 32 || depth < 2 ||
      depth > kMaxDepth || skip <= 0 || skip >= depth || nb <= 0 || nb > wtf::kMaxNb || !x0 ||
      !x1 || !w || !wt || !wc || !fh || !fl || !b || !wd || !bc || !sig || !cout || !u ||
      !a16(x0) || !a16(x1) || !a16(w) || !a16(wt) || !a16(wc) || !a16(fh) || !a16(fl) ||
      !a4(b) || !a4(bc) || (reinterpret_cast<uintptr_t>(wd) & 7) || !a16(cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(depth);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  Maps m;
  memset(&m, 0, sizeof(m));
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* tp = static_cast<const bf16*>(wt);
  size_t off = 0;
  for (int l = 0; l < depth; ++l) {
    const int k = l == 0 ? kin : (l == skip ? kW + kin : kW);
    if (!make_map(&m.w[l], wp + off, k, kW, k, 128) ||
        !make_map(&m.wt[l], tp + off, kW, k, kW, 128))
      return static_cast<int>(cudaErrorInvalidValue);
    off += static_cast<size_t>(kW) * k;
  }
  if (!make_map(&m.wc, wc, kW, kW, kW, 128) ||
      !wtf::make_map_f32(&m.fh, fh, 128, 32 * kNch, 128, 32) ||
      !wtf::make_map_f32(&m.fl, fl, 128, 32 * kNch, 128, 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const bf16*>(x0), static_cast<const bf16*>(x1), d, n, depth, skip,
                 nb, kin, static_cast<const bf16*>(b), static_cast<const float*>(wd),
                 static_cast<const bf16*>(bc), static_cast<float*>(sig), static_cast<bf16*>(cout),
                 static_cast<float*>(u)};
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(trunk_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + kTile - 1) / kTile;
  trunk_fwd_bf16_kernel<<<tiles < sms ? tiles : sms, kCtaThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

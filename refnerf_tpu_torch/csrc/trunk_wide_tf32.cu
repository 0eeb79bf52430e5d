// The f32 density-gradient forward (K3) of the wide-input spatial trunk on
// Hopper's tensor cores: three TF32 passes of wgmma fed by TMA.
//
// Replaces, for the compute dtype float32 on the JAX package's default
// spatial trunk (8 x 256 on two IPE segments of d <= 256 columns each, 504
// at the defaults, the skip at one layer, the density head and the 256-wide
// compute-dtype head, no f32 heads), the forward Pallas kernel
// `_fwd_kernel` (refnerf_tpu/ops/pallas/fused_mlp.py :612-666) with
// `density_grad`: the layers h_l = relu(acc + b_l), sigma = y wd, the
// bottleneck y wc^T + bc, the inner chain `_inner_chain` (:589-609) s_{L-1} =
// relu'(h_{L-1}) wd, s_{l-1} = relu'(h_{l-1}) (s_l Wa_l), u_x = s_skip
// Wx_skip + s_0 Wx_0 and its fold onto the lifted means (:651-662), u_m = xc
// u_xs - xs u_xc, u = u_m S. trunk_fwd_f32.cu's `fwd_f32_wide<256, true>`
// ran it before on the FMA pipes and keeps the other wide-input shapes.
//
// Bound at 524,288 rows on an H100 (1.572 TFLOP, chip_smoke.py
// `trunk_flops`): as three TF32 products, 4.72 TFLOP at 495 TFLOP/s, 9.5 ms
// (23.5 ms on the FMA pipes at 67 TFLOP/s). A 64-row tile reads every
// panel of B (the weights' TF32 parts, 12 MB) once: 98.8 GB from L2 for the
// whole call, ~10 TB/s at the tensor cores' rate. Clusters of two CTAs
// sharing each slice of B by multicast took 25.967 ms against 20.840 a CTA
// alone (PERF.md section 6): the pairs' lockstep cost more than the L2
// bytes they saved, so each CTA loads its own.
//
// The design (trunk_w1024.cu's `nt_tf32_kernel` and trunk_dir1.cu's f32
// path: hi = tf32(v), lo = tf32(v - hi), products lo.hi + hi.lo + hi.hi,
// each 32-deep slice summed into a fresh accumulator set that is added into
// the tile in f32, as the tensor cores' accumulation truncates: H26).
//  - A CTA owns a 64-row tile: two consumer warpgroups and a producer
//    warpgroup (its first thread issues the TMA loads; setmaxnreg 40),
//    consumer warpgroup c
//    owning output columns [128 c, 128 c + 128) of every product (wgmma
//    m64n128k8: 64 accumulators and 64 of the slice's part a thread).
//  - B is every product's weights, laid out by the wrapper (`fused_mlp.
//    _tf32_panels`) as 256 x 256 panels in the order the tile runs them,
//    split once a call into its TF32 parts (`refnerf_wide_tf32_split`): the
//    layers (layer 0 and the skip layer's input share one panel a
//    segment, each segment's columns padded to 256), the bottleneck, the
//    chain's W_l^T and the u_x products' [Wx_l^T] (one panel a segment).
//    Within every 8 of K the columns are permuted (slot s holds column 2 (s
//    % 4) + s / 4), so that a thread's TF32 A fragment of a k8 step, slots
//    q and q + 4, is the pair of adjacent columns 2 q, 2 q + 1 that the
//    accumulators' layout gives it: one 8-byte load a row, and an
//    epilogue's values are stored where the next product reads them. The
//    producer walks the panels 32 deep into a ring of two 64 KB stages (B's
//    hi and lo [256][32] boxes, 128-byte swizzled; a fold slice is four
//    [32][32] boxes, each warpgroup's rows of both parts).
//  - A comes from registers, split there: the activation tile (f32 [64][256]
//    in shared memory, the 8-column groups of row r XOR-swizzled by r % 4:
//    conflict-free 8-byte loads and stores), or, for the input panels, the
//    segment's [64][32] box that the producer brings by TMA beside the
//    stage's B (zeros past the segment's columns and the rows).
//  - Epilogues in registers: the bias and ReLU, relu' as 64 bits a thread
//    and layer (the last layer's kept in registers), sigma's partial dot
//    products summed over the row's 4 lanes and the two warpgroups in a
//    fixed order, the bottleneck stored from its accumulators.
//  - u_x is made per layer that reads the input (the skip layer, then layer
//    0) as two N = 256 products over s_l, one per segment. Each thread
//    scales its 64 values by the partner segment's (xc for a sin column,
//    -xs for a cos one, read from device memory) and folds them onto the
//    lifted means by one more product on the tensor cores: its
//    accumulators are that product's A fragments (K = the warpgroup's 128
//    columns, permuted as above), B the fold panel (S^T of those columns,
//    32 basis vectors, `fused_mlp.tf32_fold_panel`) from the ring; each
//    thread adds its m64n32 sums into its own 16 floats of the input slots
//    (free in the chain: kept in registers across the products they
//    spilled), and at the end the two warpgroups' are added: no CTA
//    barrier and no u_x tile. A resident s_skip (64 KB) for one product over [s_skip | s_0]
//    does not fit beside the 128 KB ring.
//  - Reruns are bit-identical: every sum runs in a fixed order.
// One CTA an SM (228,896 B of shared memory at depth 8; `kernel_smem` in
// fused_mlp.py mirrors `smem_bytes`).

#include <string.h>

#define PHASE_SYNC() cons_sync()  // closes a stamped segment
#include "hopper_tma.cuh"
#include "phase_stamps.cuh"

namespace wtf {

constexpr int kWidth = 256;       // the trunk's width, a panel's N and K
constexpr int kFK = 32;           // K of a slice (one swizzled f32 row)
constexpr int kPart = kWidth * kFK * 4;  // one TF32 part of a slice: 32 KB
constexpr int kStage = 2 * kPart;        // hi, lo
constexpr int kStages = 2;
constexpr int kXBox = kRows * kFK * 4;   // an input panel's A slice: 8 KB
constexpr int kFoldBox = 32 * kFK * 4;   // a fold slice's box of one part and warpgroup
constexpr int kMaxNb = 32;
constexpr int kWgThreads = 384;
constexpr int kProdRegs = 40;
constexpr int kConsRegs = 232;

// Dynamic shared memory of a launch: 1 KB to align the swizzled tiles, the
// ring, the activation tile, the input slices' slots (one a stage; in the
// chain each consumer thread's 16 sums of u in the same bytes), the relu'
// bits of layers 0 to depth - 2, the two warpgroups' sigma sums, the
// mbarriers.
constexpr int kSlots = kStages * kXBox;
static_assert(kCons * 16 * 4 <= kSlots, "u's sums fit in the input slots");
inline size_t smem_bytes(int depth) {
  return 1024 + static_cast<size_t>(kStages) * kStage + 4 * kRows * kWidth + kSlots +
         8 * static_cast<size_t>(depth - 1) * 256 + 4 * 2 * kRows + 8 * 2 * kStages;
}

// The panels of a tile in order: the layers (layer 0 one a segment, the
// skip layer its activation's and one a segment), the bottleneck, the chain
// (at the skip layer u_x's two before W_l^T), layer 0's u_x.
__host__ __device__ inline int panels(int depth, int skip) {
  const int sk = skip > 0 && skip < depth ? 2 : 0;
  return 2 + (depth - 1) + sk + 1 + (depth - 1) + sk + 2;
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d (+)= A B^T on one k8 step: A [64][8] tf32 from registers (a[e]: row 16
// warp + lane / 4 + 8 (e % 2), slot lane % 4 + 4 (e / 2)), B [128][8] from a
// 128-byte-swizzled K-major tile, f32 accumulation (d[4 j + 2 h + e]: row
// 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= the f32 product of one k8 step in three TF32 passes, the small
// terms first: lo.hi, hi.lo, hi.hi.
__device__ __forceinline__ void mma3(float (&d)[64], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint64_t bh, uint64_t bl,
                                     int scale_d) {
  wgmma_tf32(d, lo, bh, scale_d);
  wgmma_tf32(d, hi, bl, 1);
  wgmma_tf32(d, hi, bh, 1);
}

// As wgmma_tf32, N = 32 (the fold's basis vectors).
__device__ __forceinline__ void wgmma32_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Byte offset of element (r, c < 32) of a [rows][32] f32 box, 128-byte
// swizzled as TMA writes it.
__device__ __forceinline__ uint32_t f32_off(int r, int c) {
  return static_cast<uint32_t>(r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}
// Word offset of element (r, c) of the activation tile [64][256].
__device__ __forceinline__ int aoff(int r, int c) { return r * kWidth + (c ^ ((r & 3) << 3)); }

struct Params {
  const float* x0;    // [n][d]: the sin segment
  const float* x1;    // [n][d]: the cos segment
  int d, n, depth, skip, nb, np;
  const float* b;     // [depth][256]
  const float* wd;    // [256]
  const float* bc;    // [256]
  float* sig;         // [n]
  float* cout;        // [n][256]
  float* u;           // [n][nb]
};

struct Maps {
  CUtensorMap bh, bl;    // [np * 256][256] B's parts, boxes [256][32]
  CUtensorMap x0, x1;    // [n][d], boxes [64][32]
  CUtensorMap fh, fl;    // the fold panel's parts [2 * 32][128], boxes [32][32]
};

// What a consumer thread needs of the pipeline: the ring (full and empty
// mbarriers), the input slots, and its place in the tile.
struct Cons {
  Ring r;
  const unsigned char* xslot;  // slot 0 (one kXBox a stage)
  const float* act;
  int cw, ra, q, lane;   // warpgroup, the fragment's first row, lane % 4, lane
};

__device__ __forceinline__ void release(const Cons& c, int stage) {
  if (c.lane == 0) mbar_arrive(c.r.empty + 8 * stage);
}

// acc = A B^T over the ring's next np panels, A of panel i the activation
// tile (src bit i clear) or the input slot of each stage (set); each slice's
// products into part, then added into acc in f32. Consumer threads only.
__device__ __forceinline__ void product(float (&acc)[64], float (&part)[64], Cons& c, int np,
                                        int src) {
  uint32_t h0[4], l0[4], h1[4], l1[4];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;  // neither live before
  int prev = -1;
  for (int i = 0; i < np; ++i) {
    const bool isx = (src >> i) & 1;
    for (int kb = 0; kb < kWidth / kFK; ++kb) {
      mbar_wait(c.r.full + 8 * c.r.stage, c.r.phase);
      const uint32_t bh = c.r.base + c.r.stage * kStage + c.cw * (kPart / 2), bl = bh + kPart;
      const unsigned char* xs = c.xslot + c.r.stage * kXBox;
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
        float2 v0, v1;
        if (isx) {
          v0 = *reinterpret_cast<const float2*>(xs + f32_off(c.ra, k));
          v1 = *reinterpret_cast<const float2*>(xs + f32_off(c.ra + 8, k));
        } else {
          v0 = *reinterpret_cast<const float2*>(c.act + aoff(c.ra, kFK * kb + k));
          v1 = *reinterpret_cast<const float2*>(c.act + aoff(c.ra + 8, kFK * kb + k));
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

// Stores v (the thread's 64 values in the accumulators' layout) to the
// activation tile.
__device__ __forceinline__ void put_act(float* act, const float (&v)[64], int cw, int ra, int q) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(act + aoff(ra + 8 * h, 128 * cw + 8 * j + 2 * q)) =
          make_float2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
}

__device__ __forceinline__ bool bit(const uint2 m, int i) {
  return ((i < 32 ? m.x >> i : m.y >> (i - 32)) & 1u) != 0;
}

// u_x of one segment (acc: columns 128 cw + 8 j + 2 q + e of segment seg,
// rows row0 + ra + 8 h) folded into u (fu, m64n32: basis vector 8 j + 2 q +
// e of rows ra + 8 h, added into the thread's own 16 floats `us` of
// shared memory), as one more product on the tensor cores: u_m =
// partner * u_x (seg 0, sin: xc; seg 1, cos: -xs; read from device memory,
// the next slice's in flight), whose accumulator layout is the A fragments'
// of K = the warpgroup's 128 columns (slots q, q + 4 of step j: columns 8 j
// + 2 q, + 1), against the fold panel (S^T of those columns, permuted alike)
// from the ring, 4 slices of 32, three TF32 passes, each slice's products
// added into fu in f32.
__device__ __forceinline__ void fold(const float (&acc)[64], float* us, Cons& c, const Params& p,
                                     int seg, int row0) {
  const float* xp = seg == 0 ? p.x1 : p.x0;
  const float sgn = seg == 0 ? 1.f : -1.f;
  const int col0 = 128 * c.cw + 2 * c.q;
  auto partner = [&](int j, int h) {
    const int row = row0 + c.ra + 8 * h, col = col0 + 8 * j;
    return row < p.n && col < p.d
               ? __ldg(reinterpret_cast<const float2*>(xp + static_cast<size_t>(row) * p.d + col))
               : make_float2(0.f, 0.f);
  };
  uint32_t h0[4], l0[4], h1[4], l1[4];
  float part[16] = {}, fu[16] = {};
  float2 xv[2][4][2];  // a slice's partner values, the next slice's in flight
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) xv[0][kk][h] = partner(kk, h);
  int prev = -1;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    if (kb < 3) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) xv[(kb + 1) & 1][kk][h] = partner(4 * kb + 4 + kk, h);
    }
    mbar_wait(c.r.full + 8 * c.r.stage, c.r.phase);
    const uint32_t bh = c.r.base + c.r.stage * kStage + c.cw * (kPart / 2), bl = bh + kPart;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t(&hi)[4] = (kk & 1) ? h1 : h0;
      uint32_t(&lo)[4] = (kk & 1) ? l1 : l0;
      if (kk == 0) {
        wg_wait<0>();
        if (prev >= 0) {
          release(c, prev);
#pragma unroll
          for (int e = 0; e < 16; ++e) asm volatile("" : "+f"(part[e])::"memory");
#pragma unroll
          for (int e = 0; e < 16; ++e) fu[e] += part[e];
        }
      } else {
        wg_wait<1>();
      }
      const int j = 4 * kb + kk;
      const float2 x0 = xv[kb & 1][kk][0], x1 = xv[kb & 1][kk][1];
      split_tf32(sgn * x0.x * acc[4 * j], hi[0], lo[0]);
      split_tf32(sgn * x1.x * acc[4 * j + 2], hi[1], lo[1]);
      split_tf32(sgn * x0.y * acc[4 * j + 1], hi[2], lo[2]);
      split_tf32(sgn * x1.y * acc[4 * j + 3], hi[3], lo[3]);
      wg_fence();
      wgmma32_tf32(part, lo, sw128_desc(bh + 32 * kk, 16, 1024), kk);
      wgmma32_tf32(part, hi, sw128_desc(bl + 32 * kk, 16, 1024), 1);
      wgmma32_tf32(part, hi, sw128_desc(bh + 32 * kk, 16, 1024), 1);
      wg_commit();
    }
    prev = c.r.stage;
    c.r.advance();
  }
  wg_wait<0>();
  release(c, prev);
#pragma unroll
  for (int e = 0; e < 16; ++e) asm volatile("" : "+f"(part[e])::"memory");
#pragma unroll
  for (int e = 0; e < 16; ++e) us[e] += fu[e] + part[e];
}

// One 64-row tile a CTA. Threads 0-255: the consumers; 256-383: the
// producer warpgroup
// (thread 256 walks the panels: B's parts, and the input slices of the
// input panels).
__global__ void __launch_bounds__(kWgThreads, 1)
    trunk_fwd_tf32_kernel(const __grid_constant__ Params p, const __grid_constant__ Maps m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* act = reinterpret_cast<float*>(smem + kStages * kStage);
  float* slots = act + kRows * kWidth;  // kStages x [64][32] inputs; the chain's u [2][64][nb]
  uint2* masks = reinterpret_cast<uint2*>(slots + kSlots / 4);           // [depth - 1][256]
  float* red = reinterpret_cast<float*>(masks + (p.depth - 1) * kCons);  // [2][64]
  const uint32_t full = smem_u32(red + 2 * kRows), empty = full + 8 * kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int row0 = blockIdx.x * kRows;

  if (warp >= kCons / 32) {
    reg_dealloc<kProdRegs>();
    if (tid == kCons) {
      Ring r{smem_u32(smem), full, empty, kStages, 0, 0u};
      // The tile's order (the consumers' below): B panel pn's 8 slices,
      // with the segment's input slice beside each (xs 0 or 1) or not (-1);
      // the fold panel's 4 after each u_x product.
      auto panel = [&](int pn, int xs) {
        for (int kb = 0; kb < kWidth / kFK; ++kb) {
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kStage;
          mbar_expect_tx(f, kStage + (xs >= 0 ? kXBox : 0));
          tma_load(dst, &m.bh, f, kFK * kb, kWidth * pn);
          tma_load(dst + kPart, &m.bl, f, kFK * kb, kWidth * pn);
          if (xs >= 0)
            tma_load(smem_u32(slots) + r.stage * kXBox, xs ? &m.x1 : &m.x0, f, kFK * kb, row0);
          r.advance();
        }
      };
      auto fold_panel = [&]() {  // rows 32 cw + j to each warpgroup's B rows
        for (int kb = 0; kb < 4; ++kb) {
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kStage;
          mbar_expect_tx(f, 4 * kFoldBox);
          for (int part = 0; part < 2; ++part)
            for (int cw = 0; cw < 2; ++cw)
              tma_load(dst + part * kPart + cw * (kPart / 2), part ? &m.fl : &m.fh, f, kFK * kb,
                       32 * cw);
          r.advance();
        }
      };
      int pn = 0;
      panel(pn++, 0);
      panel(pn++, 1);
      for (int l = 1; l < p.depth; ++l) {
        panel(pn++, -1);
        if (l == p.skip) {
          panel(pn++, 0);
          panel(pn++, 1);
        }
      }
      panel(pn++, -1);  // the bottleneck
      for (int l = p.depth - 1; l >= 0; --l) {
        if (l == 0 || l == p.skip)
          for (int seg = 0; seg < 2; ++seg) {
            panel(pn++, -1);
            fold_panel();
          }
        if (l > 0) panel(pn++, -1);
      }
    }
  } else {
    reg_alloc<kConsRegs>();
    PHASE_START;
    const int ctid = tid, cw = ctid >> 7, cwarp = (ctid >> 5) & 3;
    const int g = lane >> 2, q = lane & 3, ra = 16 * cwarp + g;
    Cons c{Ring{smem_u32(smem), full, empty, kStages, 0, 0u},
           reinterpret_cast<const unsigned char*>(slots), act, cw, ra, q, lane};
    float acc[64], part[64];
    uint2 mlast = make_uint2(0u, 0u);  // relu' of the last layer

    // 1. The layers: h_l = relu(acc + b_l), relu' as bits; y stays in the
    // tile for the bottleneck, and sigma = y wd.
    for (int l = 0; l < p.depth; ++l) {
      const bool sk = l == p.skip && l > 0;
      product(acc, part, c, l == 0 ? 2 : (sk ? 3 : 1), l == 0 ? 3 : (sk ? 6 : 0));
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
      cons_sync();  // every consumer's product has read the tile
      put_act(act, acc, cw, ra, q);
      if (l + 1 < p.depth) {
        masks[l * kCons + ctid] = mk;
      } else {
        mlast = mk;
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 w = __ldg(reinterpret_cast<const float2*>(p.wd + 128 * cw + 8 * j + 2 * q));
#pragma unroll
          for (int h = 0; h < 2; ++h)
            s[h] = fmaf(acc[4 * j + 2 * h + 1], w.y, fmaf(acc[4 * j + 2 * h], w.x, s[h]));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
          if (q == 0) red[cw * kRows + ra + 8 * h] = s[h];
        }
      }
      cons_sync();
      PHASE_MARK(1, kScal);
    }
    if (ctid < kRows && row0 + ctid < p.n) p.sig[row0 + ctid] = red[ctid] + red[kRows + ctid];

    // 2. The bottleneck y wc^T + bc from its accumulators.
    product(acc, part, c, 1, 0);
    PHASE_MARK(2, kProd);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 128 * cw + 8 * j + 2 * q;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(p.bc + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + ra + 8 * h;
        if (row < p.n)
          *reinterpret_cast<float2*>(p.cout + static_cast<size_t>(row) * kWidth + col) =
              make_float2(acc[4 * j + 2 * h] + bb.x, acc[4 * j + 2 * h + 1] + bb.y);
      }
    }
    PHASE_MARK(2, kStore);

    // 3. The chain: s_{L-1} = relu'(h_{L-1}) wd, then s_{l-1} = relu'(h_{l-1})
    // (s_l Wa_l); u_x of the skip layer (before its s product) and of layer
    // 0, each segment's folded into u (each thread's 16 sums in the slots).
    float* us = slots + 16 * ctid;
#pragma unroll
    for (int e = 0; e < 16; ++e) us[e] = 0.f;
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
    cons_sync();  // the bottleneck's product has read y
    put_act(act, acc, cw, ra, q);
    cons_sync();
    PHASE_MARK(3, kScal);
    for (int l = p.depth - 1; l >= 0; --l) {
      if (l == 0 || l == p.skip) {
        for (int seg = 0; seg < 2; ++seg) {
          product(acc, part, c, 1, 0);
          fold(acc, us, c, p, seg, row0);
          PHASE_MARK(3, kProd);
        }
      }
      if (l == 0) break;
      product(acc, part, c, 1, 0);
      PHASE_MARK(3, kProd);
      const uint2 mk = masks[(l - 1) * kCons + ctid];
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (!bit(mk, i)) acc[i] = 0.f;
      cons_sync();  // every consumer's product has read s_l
      put_act(act, acc, cw, ra, q);
      cons_sync();
      PHASE_MARK(3, kScal);
    }
    // u = the two warpgroups' sums, warpgroup 0's first (thread t of each
    // holds the same entries).
    cons_sync();
    if (cw == 0)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = row0 + ra + 8 * h, j = 8 * jj + 2 * q + e, i = 4 * jj + 2 * h + e;
            if (row < p.n && j < p.nb)
              p.u[static_cast<size_t>(row) * p.nb + j] = us[i] + us[16 * 128 + i];
          }
    PHASE_MARK(3, kStore);
  }
}

// y[i] = hi and lo, the TF32 parts of src[idx[i]] (src = w for idx < nw, wc
// at idx - nw past it; 0 for idx < 0).
__global__ void __launch_bounds__(256) split_kernel(int n, const int* idx, const float* w, int nw,
                                                   const float* wc, float* hi, float* lo) {
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    const int k = idx[i];
    const float v = k < 0 ? 0.f : (k < nw ? w[k] : wc[k - nw]);
    uint32_t h, l;
    split_tf32(v, h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// A tensor map of a row-major f32 matrix [rows][cols] (row stride `ld`
// elements) in boxes of box_rows x 32 columns, 128-byte swizzled; reads
// past the matrix give zeros.
inline bool make_map_f32(CUtensorMap* map, const void* base, int cols, int rows, int ld,
                         int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr || cols <= 0 || rows <= 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {kFK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

int launch(const Params& p, const Maps& m, cudaStream_t s) {
  const size_t smem = smem_bytes(p.depth);
  const cudaError_t e = cudaFuncSetAttribute(
      trunk_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  trunk_fwd_tf32_kernel<<<(p.n + kRows - 1) / kRows, kWgThreads, smem, s>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wtf

// B's TF32 parts: hi[i], lo[i] of w[idx[i]] (idx < nw), wc[idx[i] - nw]
// (past it) or 0 (idx < 0), for i < n: the panels of `fused_mlp.
// _tf32_panels`, split once a call.
extern "C" int refnerf_wide_tf32_split(int n, const void* idx, const void* w, int nw,
                                       const void* wc, void* hi, void* lo, void* stream) {
  if (n <= 0 || !idx || !w || !hi || !lo) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  wtf::split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(idx), static_cast<const float*>(w), nw,
      static_cast<const float*>(wc), static_cast<float*>(hi), static_cast<float*>(lo));
  return static_cast<int>(cudaGetLastError());
}

// K3 of the wide-input spatial trunk in f32 (see the top of this file): n
// rows of the segments x0, x1 [n][d] (d even, a multiple of 4, at most 256;
// contiguous, 16-byte aligned), depth layers of width 256 with the skip at
// layer `skip`, B's parts bh, bl [np * 256][256] (`refnerf_wide_tf32_split`
// of the panels), the biases b [depth][256], the density head wd [256], the
// bottleneck's bias bc [256], the fold S [d][nb] (nb <= 32); out sigma [n],
// the bottleneck [n][256], u [n][nb], all f32. Returns the
// cudaError_t of the launch; allocates nothing and does not synchronise.
extern "C" int refnerf_wide_tf32_k3(int n, int d, int depth, int skip, int nb, const void* x0,
                                    const void* x1, const void* bh, const void* bl, int np,
                                    const void* fh, const void* fl, const void* b, const void* wd,
                                    const void* bc, void* sig, void* cout, void* u,
                                    void* stream) {
  using namespace wtf;
  if (n <= 0 || d <= 0 || d > kWidth || d % 4 || depth < 2 || depth > kMaxDepth || nb <= 0 ||
      nb > kMaxNb || np != panels(depth, skip) || !x0 || !x1 || !bh || !bl || !fh || !fl || !b ||
      !wd || !bc || !sig || !cout || !u || !aligned16(x0) || !aligned16(x1) || !aligned16(bh) ||
      !aligned16(bl) || !aligned16(fh) || !aligned16(fl) || (reinterpret_cast<uintptr_t>(b) & 7) ||
      (reinterpret_cast<uintptr_t>(wd) & 7) || (reinterpret_cast<uintptr_t>(bc) & 7) ||
      (reinterpret_cast<uintptr_t>(cout) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(depth) > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  Maps m;
  memset(&m, 0, sizeof(m));
  if (!make_map_f32(&m.bh, bh, kWidth, np * kWidth, kWidth, kWidth) ||
      !make_map_f32(&m.bl, bl, kWidth, np * kWidth, kWidth, kWidth) ||
      !make_map_f32(&m.x0, x0, d, n, d, kRows) || !make_map_f32(&m.x1, x1, d, n, d, kRows) ||
      !make_map_f32(&m.fh, fh, 128, 64, 128, 32) || !make_map_f32(&m.fl, fl, 128, 64, 128, 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(x0), static_cast<const float*>(x1), d, n, depth, skip,
                 nb, np, static_cast<const float*>(b), static_cast<const float*>(wd),
                 static_cast<const float*>(bc), static_cast<float*>(sig),
                 static_cast<float*>(cout), static_cast<float*>(u)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(p, m, s);
}

// The depth-1 directional trunk of mip-NeRF 360's NeRF MLP, forward (K2)
// and backward with the segments' cotangents (K5, needs_dx): one layer of
// width 128 on [bottleneck 256 | positional encoding d1 <= 29 (27 at
// deg_view 4)], h = relu(cdt(x W1^T) + cdt(b1)), and the f32 rgb head of at
// most 3 outputs, rgb = f32(h) wh^T + bh.
//
// Replaces, on this shape, the Pallas pair of
// refnerf_tpu/ops/pallas/fused_mlp.py: `_fwd_kernel` :612 (K2) and
// `_bwd_kernel` :668 with `needs_dx` (K5), which trunk_fwd.cu and
// trunk_bwd.cu run past the TMA kernels' 256 input columns (one CTA a
// 64-row tile streaming the whole layer through a cp.async ring; the
// backward's weight-gradient operands written feature-major and read back;
// dx stored a scalar at a time). The TPU kernel keeps a block of rows and
// the layer in VMEM; here the layer (72 KB in bf16) stays in shared memory.
//
// Bound at 524,288 rows on an H100 (989 TFLOP/s bf16, 495 TF32, 3.35
// TB/s): bf16 by bytes, each input read once and each output written once,
// 0.090 ms forward (the input's 0.30 GB) and 0.179 ms backward (the input
// and dx); f32 by the tensor cores' operations as three TF32 products,
// 0.233 ms forward and 0.697 ms backward (on the FMA pipes at 67 TFLOP/s
// 0.573 / 1.713 ms).
//
// The design. Persistent CTAs, one an SM, walk the row tiles in a fixed
// order (tile blockIdx.x + i gridDim.x). Thread 0 of a producer warpgroup
// (setmaxnreg down to 40 registers) keeps the tiles' copies in flight into a
// ring of mbarrier-guarded stages; two consumer warpgroups run wgmma.
// - The bottleneck segment comes by a TMA tensor map (128-byte swizzle). The
//   d1-column segment cannot (its rows of 54 or 108 bytes are no multiple
//   of 16), but a tile of it is one contiguous span whose start is 16-byte
//   aligned: it comes by one bulk copy (cp.async.bulk) onto the stage's
//   mbarrier, and the consumers read it into wgmma's A registers (K
//   256-287, zeros past d1). The last tile, when partial, is read from
//   device memory instead (plain loads, rows masked).
// - bf16 (`dir1_bf16_kernel`): W1 resident (5 TMA boxes of [128][64],
//   zeros past 288); 64-row tiles, each taken whole by one consumer
//   warpgroup (the CTA's tiles alternate between the two), in a ring of 3
//   stages; wgmma m64n128k16, 16 steps from shared memory and 2 with A in
//   registers.
// - f32 (`dir1_f32_kernel`): three TF32 passes (hi = tf32(v), lo = tf32(v
//   - hi); lo.hi + hi.lo + hi.hi), as trunk_w1024.cu's nt_tf32_kernel: A
//   split in registers, W1's parts split once a call (`refnerf_dir1_split`)
//   and brought by TMA as B a 32-deep slice a stage (295 KB together: not
//   resident); 128-row tiles, 64 rows a consumer warpgroup, each slice's
//   products summed into the tile in f32 (the tensor cores' accumulation
//   truncates: H26).
// - The epilogue runs in registers: h, then the rgb head as dot products
//   reduced over the 4 lanes of a row, rgb stored as f32.
// - The backward recomputes h, then g = cdt(hbar wh), zeta = relu'(h) g
//   (its f32 head's cotangent hbar comes with the tile), dx = zeta W1 with
//   zeta as wgmma's A from registers (the accumulators' layout is the A
//   fragments': bf16 as is; TF32 reads columns q, q + 4 of a k8 step where a
//   thread holds 2q, 2q + 1, so W1^T comes with the hidden units of every 8
//   permuted to match), N in chunks (bf16 128, 128, 64 with W1 read
//   MN-major by the transpose bit; f32 3 x 96 from W1^T's parts, each
//   32-deep slice summed in f32), dx stored in the segments' compute dtype.
//   The head's gradients dwh = hbar^T h and dbh are reduced over a warp's
//   rows by shuffles (a reduce-scatter a head output at a time: each lane
//   keeps 4 of its columns' 32 sums) into the warp's sums in shared memory,
//   then per CTA in a fixed order into `hpart`. The layer's gradient dW1 = zeta^T x and db1 sum over all rows:
//   a 128 x 288 f32 partial fits neither a warpgroup's registers nor shared
//   memory beside the layer and a ring, so the kernel writes zeta (compute
//   dtype) and the d1-column segment zero-padded to 32 columns, and
//   trunk_w1024.cu's weight-gradient product (its bias sums folded in) runs
//   over them and the bottleneck; trunk_bwd.cu's refnerf_reduce sums every
//   partial in a fixed order (H4). Scratch is sized by the most partials
//   any row count makes (H24).
//
// ptxas (sm_90a; chip_smoke.py's phase 2 prints it from the build's log):
// 168 registers a thread at launch (384 threads, one CTA an SM), no spills
// but 148 bytes in the f32 backward (zeta's 64 values, dx's 48
// accumulators and two sets of TF32 fragments live through dx); the
// consumers' setmaxnreg of 232 does not lift ptxas's allocation, so the
// live sets were cut to fit: the head's sums in shared memory, its
// reduce-scatter a head output at a time, dx's f32 accumulators one set.

#include <string.h>

#include "hopper_tma.cuh"

namespace dir1 {

using bf16 = __nv_bfloat16;

constexpr int kWidth = 128;   // the trunk's width
constexpr int kD0 = 256;      // the bottleneck segment's columns
constexpr int kKin = 288;     // packed input columns (256 + d1, rounded to 32)
constexpr int kD1Max = 29;    // f32: a tile's span and hbar share a 16 KB slot
constexpr int kHf = 3;        // f32 head outputs at most (rgb)
constexpr int kParts = kHf * kWidth + kHf;  // a CTA's head partial: dwh | dbh
constexpr int kWgThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kProdRegs = 40;
constexpr int kConsRegs = 232;
constexpr int kHead = 4 * (kHf * kWidth + kWidth + 4);  // wh, b (f32), bh
constexpr int kHeadAcc = 4 * 8 * kParts;  // the backward's sums, a consumer warp each

// bf16: 64-row tiles; W1 resident as five [128][64] boxes; a stage holds a
// tile's bottleneck (four [64][64] boxes), its d1-column span and (the
// backward) its head cotangents.
constexpr int kBRows = 64;
constexpr int kBStages = 3;
constexpr int kBBox = kBRows * 128;
constexpr int kWBox = kWidth * 128;
constexpr int kWBoxes = 5;
constexpr int kBX0 = 4 * kBBox;
constexpr int kBStage = kBX0 + 5 * 1024;
// Dynamic shared memory (fused_mlp.kernel_smem mirrors it): 1 KB to align
// the swizzled tiles, W1, the ring, the head and its sums, the mbarriers
// (full, empty, W1's).
constexpr int kBBars = 2 * kBStages + 1;
constexpr int kBSmem = 1024 + kWBoxes * kWBox + kBStages * kBStage + kHead + kHeadAcc + 8 * kBBars;

// f32: 128-row tiles; a stage holds a 32-deep slice: A ([128][32] of the
// bottleneck, or the tile's d1-column span and head cotangents) and W1's
// two parts ([128][32] each; the backward's dx slices [96][32] of W1^T's).
constexpr int kFRows = 128;
constexpr int kFStages = 4;
constexpr int kFSlot = 128 * 128;
constexpr int kFStage = 3 * kFSlot;
constexpr int kFDxN = 96;
constexpr int kFSmem = 1024 + kFStages * kFStage + kHead + kHeadAcc + 8 * 2 * kFStages;

__device__ __forceinline__ float act(float v, float b, bool bf) {
  return fmaxf(bf ? round_t<bf16>(round_t<bf16>(v) + b) : v + b, 0.f);
}

// Bulk copy (no tensor map) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) onto the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// Byte offset of element (r, c < 32) of a [rows][32] f32 box, 128-byte
// swizzled as TMA writes it.
__device__ __forceinline__ uint32_t f32_off(int r, int c) {
  return static_cast<uint32_t>(r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Elements (r, c) and (r, c + 1) of a row-major [.][d1] bf16 span as one
// bf16x2 register, zeros past d1 or where !ok.
__device__ __forceinline__ uint32_t pair(const bf16* x, int r, int c, bool ok, int d1) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(x) + r * d1 + c;
  const uint32_t lo = ok && c < d1 ? u[0] : 0u;
  const uint32_t hi = ok && c + 1 < d1 ? u[1] : 0u;
  return lo | (hi << 16);
}

// The 128 threads of consumer warpgroup cw (named barrier 2 + cw).
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + cw) : "memory");
}

// Bulk copy (no tensor map) of `bytes` of shared memory to device memory, in
// the thread's bulk async-group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}

// Waits until at most one of the thread's bulk groups still reads shared
// memory.
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

template <int N> __device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T on one k16 step: A [64][16] bf16 from registers (a[i]: row
// 16 warp + lane / 4 + 8 (i % 2), columns 2 (lane % 4) + 8 (i / 2) and the
// next), B [N][16] from shared memory (TB: MN-major), f32 accumulation
// (d[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane %
// 4) + e).
template <int TB>
__device__ __forceinline__ void wgmma128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// As wgmma128_rs, N = 64.
template <int TB>
__device__ __forceinline__ void wgmma64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// d (+)= A B^T on one k8 step: A [64][8] tf32 from registers (a[e]: row 16
// warp + lane / 4 + 8 (e % 2), column lane % 4 + 4 (e / 2)), B [N][8] from a
// 128-byte-swizzled K-major tile, f32 accumulation (d as wgmma128_rs's).
__device__ __forceinline__ void wgmma128_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
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

// As wgmma128_tf32, N = 96.
__device__ __forceinline__ void wgmma96_tf32(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= the f32 product of one k8 step in three TF32 passes, the small
// terms first: lo.hi, hi.lo, hi.hi.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint64_t bh, uint64_t bl,
                                     int scale_d) {
  if constexpr (N == 128) {
    wgmma128_tf32(d, lo, bh, scale_d);
    wgmma128_tf32(d, hi, bl, 1);
    wgmma128_tf32(d, hi, bh, 1);
  } else {
    wgmma96_tf32(d, lo, bh, scale_d);
    wgmma96_tf32(d, hi, bl, 1);
    wgmma96_tf32(d, hi, bh, 1);
  }
}

struct Params {
  int M, d1, hf, tiles;
  const void* x1;     // [M][d1] cdt: the positional encoding
  const void* b;      // [128] cdt
  const float* wh;    // [hf][128]
  const float* bh;    // [hf]
  const float* hbar;  // [M][hf]: rgb's cotangent (backward)
  float* rgb;         // [M][hf] (forward)
  void* dx0;          // [M][256] cdt (backward)
  void* dx1;          // [M][d1] cdt (backward)
  void* z;            // [M][128] cdt: zeta (backward)
  void* x1p;          // [M][32] cdt: x1 zero-padded (backward)
  float* hpart;       // [gridDim.x][kParts]: dwh [3][128] | dbh [3] (backward)
};

struct BMaps {
  CUtensorMap x0, w;    // boxes [64][64] of the bottleneck, [128][64] of W1
  CUtensorMap z, dx0;   // boxes [64][64]: the backward's zeta and dx0 stores
};

struct FMaps {
  CUtensorMap x0, wh, wl, th, tl;  // boxes [128][32]; W1^T's parts [96][32]
};

// The head (wh, b, bh) into shared memory, zeros past hf, and its sums
// zeroed; consumers only.
template <typename T>
__device__ void load_head(const Params& p, float* swh, float* sb, float* sbh, float* hacc,
                          int ctid) {
  for (int i = ctid; i < 8 * kParts; i += kCons) hacc[i] = 0.f;
  for (int i = ctid; i < kHf * kWidth; i += kCons) swh[i] = i < p.hf * kWidth ? p.wh[i] : 0.f;
  for (int i = ctid; i < kWidth; i += kCons) sb[i] = to_f(static_cast<const T*>(p.b)[i]);
  if (ctid < kHf) sbh[ctid] = ctid < p.hf && p.bh ? p.bh[ctid] : 0.f;
  cons_sync();
}

// rgb of rows `row` and row + 8 (fragment rows g, g + 8) from the layer's
// sums acc: h = act(acc), each lane's dot products over its 32 columns,
// then over the 4 lanes of the row (xor 1, then 2).
__device__ __forceinline__ void head_forward(const float (&acc)[64], const Params& p,
                                             const float* swh, const float* sb, const float* sbh,
                                             int row, int q, bool bf) {
  float o[2][kHf];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < kHf; ++k) o[h][k] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * q + e;
      const float bc = sb[c];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float hv = act(acc[4 * j + 2 * h + e], bc, bf);
#pragma unroll
        for (int k = 0; k < kHf; ++k) o[h][k] = fmaf(hv, swh[k * kWidth + c], o[h][k]);
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < kHf; ++k) {
      o[h][k] += __shfl_xor_sync(0xffffffffu, o[h][k], 1);
      o[h][k] += __shfl_xor_sync(0xffffffffu, o[h][k], 2);
    }
  if (q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= p.M) continue;
#pragma unroll
      for (int k = 0; k < kHf; ++k)
        if (k < p.hf) p.rgb[static_cast<size_t>(r) * p.hf + k] = o[h][k] + sbh[k];
    }
  }
}

// v[32] summed over the 8 lanes of each lane % 4 (a warp's 16 rows): lane
// 4 g + q keeps entries [4 g, 4 g + 4) in v[0..3] (halving the set a
// step: xor 16, 8, 4).
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int g) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool up = g & 4;
    const float send = up ? v[i] : v[i + 16], keep = up ? v[i + 16] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool up = g & 2;
    const float send = up ? v[i] : v[i + 8], keep = up ? v[i + 8] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = g & 1;
    const float send = up ? v[i] : v[i + 4], keep = up ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
}

// The head's backward on a tile's fragment rows (hb: their rgb cotangents):
// acc becomes zeta = relu'(h) cdt(hbar wh); the rows' terms of dwh = hbar^T
// h, summed over the warp's rows one k at a time (`reduce_scatter`), go into
// the warp's sums `ha` (lane 4 g + q adds dwh[k][8 j + 2 q + e] for j = 2 g
// + i / 2, e = i % 2, i < 4), and of dbh (lane 0) after dwh's 3 x 128.
__device__ __forceinline__ void head_backward(float (&acc)[64], const float (&hb)[2][kHf],
                                              const float* swh, const float* sb, float* ha, int g,
                                              int lane, bool bf) {
  const int q = lane & 3;
  // acc holds h, then (after dwh's terms) zeta.
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float bc = sb[8 * j + 2 * q + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[4 * j + 2 * h + e] = act(acc[4 * j + 2 * h + e], bc, bf);
    }
#pragma unroll
  for (int k = 0; k < kHf; ++k) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[2 * j + e] = fmaf(hb[1][k], acc[4 * j + 2 + e], hb[0][k] * acc[4 * j + e]);
    reduce_scatter(v, g);
#pragma unroll
    for (int i = 0; i < 4; ++i) ha[k * kWidth + 8 * (2 * g + (i >> 1)) + 2 * q + (i & 1)] += v[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * q + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& a = acc[4 * j + 2 * h + e];
        float gs = hb[h][0] * swh[c];
#pragma unroll
        for (int k = 1; k < kHf; ++k) gs = fmaf(hb[h][k], swh[k * kWidth + c], gs);
        a = a > 0.f ? (bf ? round_t<bf16>(gs) : gs) : 0.f;
      }
    }
#pragma unroll
  for (int k = 0; k < kHf; ++k) {
    float s = hb[0][k] + hb[1][k];
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane == 0) ha[kHf * kWidth + k] += s;
  }
}

// The CTA's head partial: the 8 consumer warps' sums (`hacc`, kParts each)
// added in order into hpart[blockIdx.x].
__device__ __forceinline__ void head_partial(const Params& p, const float* hacc, int ctid) {
  cons_sync();
  for (int i = ctid; i < kParts; i += kCons) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += hacc[w * kParts + i];
    p.hpart[static_cast<size_t>(blockIdx.x) * kParts + i] = s;
  }
}

// ------------------------------------------------ bf16: wgmma fed by TMA

// Tile t of the CTA's walk (its i-th) is rows 64 t, taken by consumer
// warpgroup i % 2 from stage i % 3. Threads 0-127: the producer warpgroup
// (thread 0: W1 once, then each tile's bottleneck by TMA and its span and
// head cotangents by bulk copies); 128-383: the consumers.
template <bool BWD>
__global__ void __launch_bounds__(kWgThreads, 1)
    dir1_bf16_kernel(const __grid_constant__ Params p, const __grid_constant__ BMaps m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* stages = smem + kWBoxes * kWBox;
  float* swh = reinterpret_cast<float*>(stages + kBStages * kBStage);
  float* sb = swh + kHf * kWidth;
  float* sbh = sb + kWidth;
  float* hacc = sbh + 4;
  const uint32_t full = smem_u32(hacc + 8 * kParts), empty = full + 8 * kBStages;
  const uint32_t wbar = empty + 8 * kBStages, wb = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    reg_dealloc<kProdRegs>();
    if (tid == 0) {
      mbar_expect_tx(wbar, kWBoxes * kWBox);
      for (int c = 0; c < kWBoxes; ++c) tma_load(wb + c * kWBox, &m.w, wbar, 64 * c, 0);
      const uint32_t x1b = kBRows * p.d1 * 2, hbb = BWD ? kBRows * p.hf * 4 : 0;
      int i = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++i) {
        const int s = i % kBStages;
        mbar_wait(empty + 8 * s, ((i / kBStages) & 1) ^ 1u);
        const int r0 = t * kBRows;
        const bool whole = r0 + kBRows <= p.M;
        const uint32_t f = full + 8 * s, dst = smem_u32(stages + s * kBStage);
        mbar_expect_tx(f, kBX0 + (whole ? x1b + hbb : 0));
        for (int c = 0; c < 4; ++c) tma_load(dst + c * kBBox, &m.x0, f, 64 * c, r0);
        if (whole) {
          bulk_load(dst + kBX0, static_cast<const bf16*>(p.x1) + static_cast<size_t>(r0) * p.d1,
                    x1b, f);
          if (BWD) bulk_load(dst + kBX0 + x1b, p.hbar + static_cast<size_t>(r0) * p.hf, hbb, f);
        }
      }
    }
    return;
  }

  reg_alloc<kConsRegs>();
  const int ctid = tid - 128, cw = ctid >> 7, cwarp = (ctid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  load_head<bf16>(p, swh, sb, sbh, hacc, ctid);
  mbar_wait(wbar, 0);
  float* ha = hacc + (ctid >> 5) * kParts;
  int i = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++i) {
    if ((i & 1) != cw) continue;
    const int s = i % kBStages, r0 = t * kBRows, ra = 16 * cwarp + g;
    const bool whole = r0 + kBRows <= p.M;
    const bool va = r0 + ra < p.M, vb = r0 + ra + 8 < p.M;
    unsigned char* st = stages + s * kBStage;
    const bf16* xs = whole ? reinterpret_cast<const bf16*>(st + kBX0)
                           : static_cast<const bf16*>(p.x1) + static_cast<size_t>(r0) * p.d1;
    mbar_wait(full + 8 * s, (i / kBStages) & 1);
    // K 256-287: the d1-column segment's A fragments, zeros past d1.
    uint32_t xa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int c = 16 * kk + 2 * q;
      xa[kk][0] = pair(xs, ra, c, va, p.d1);
      xa[kk][1] = pair(xs, ra + 8, c, vb, p.d1);
      xa[kk][2] = pair(xs, ra, c + 8, va, p.d1);
      xa[kk][3] = pair(xs, ra + 8, c + 8, vb, p.d1);
    }
    float acc[64];
    const uint32_t sa = smem_u32(st);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma128<0, 0>(acc, sw128_desc(sa + kb * kBBox + 32 * kk, 16, 1024),
                       sw128_desc(wb + kb * kWBox + 32 * kk, 16, 1024), kb | kk);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma128_rs<0>(acc, xa[kk], sw128_desc(wb + 4 * kWBox + 32 * kk, 16, 1024), 1);
    wg_commit();
    wg_wait<0>();
    acc_fence(acc);

    if (!BWD) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      head_forward(acc, p, swh, sb, sbh, r0 + ra, q, true);
      continue;
    }
    // The rows' head cotangents, and the segment zero-padded to 32 columns
    // (thread 32 w + l of the warpgroup: row 16 w + l / 2, the half l % 2:
    // its warp's own rows).
    const float* hs = whole ? reinterpret_cast<const float*>(st + kBX0 + kBRows * p.d1 * 2)
                            : p.hbar + static_cast<size_t>(r0) * p.hf;
    float hb[2][kHf];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < kHf; ++k)
        hb[h][k] = k < p.hf && (h ? vb : va) ? hs[(ra + 8 * h) * p.hf + k] : 0.f;
    const int wt = ctid & 127;
    {
      const int row = wt >> 1, half = wt & 1;
      if (r0 + row < p.M) {
        uint32_t w[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) w[c] = pair(xs, row, 16 * half + 2 * c, true, p.d1);
        uint4* dst = reinterpret_cast<uint4*>(static_cast<bf16*>(p.x1p) +
                                              static_cast<size_t>(r0 + row) * 32 + 16 * half);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }

    head_backward(acc, hb, swh, sb, ha, g, lane, true);
    // zeta as wgmma's A fragments (8 k16 steps of its 128 columns).
    uint32_t za[32];
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8)
#pragma unroll
      for (int f = 0; f < 4; ++f) za[4 * k8 + f] = pack2(acc[8 * k8 + 2 * f], acc[8 * k8 + 2 * f + 1]);
    // The stores leave by TMA from the stage, whose bottleneck tile (four
    // swizzled [64][64] boxes) the products no longer read: zeta from boxes
    // 0-1, dx0's columns 0-127 from boxes 2-3, then 128-255 from boxes 0-1
    // once zeta's store has read them; dx1 from the span's slot by one bulk
    // copy (plain stores for a partial tile). Thread 0 of the warpgroup
    // issues them; the stage goes back once they have read it.
    const bool lead = wt == 0;
    const uint32_t sa0 = smem_u32(st);
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        *reinterpret_cast<uint32_t*>(st + sw_off(ra + 8 * (f & 1), 16 * k8 + 8 * (f >> 1) + 2 * q)) =
            za[4 * k8 + f];
    fence_async_smem();
    wg_sync(cw);
    if (lead) {
      tma_store(&m.z, sa0, 0, r0);
      tma_store(&m.z, sa0 + kBBox, 64, r0);
      bulk_commit();
    }
    // dx = zeta W1: W1 [128 hidden][288] read MN-major, N in 128, 128, 64.
#pragma unroll
    for (int nc = 0; nc < 2; ++nc) {
      float d[64];
      wg_fence();
#pragma unroll
      for (int k8 = 0; k8 < 8; ++k8) {
        const uint32_t a[4] = {za[4 * k8], za[4 * k8 + 1], za[4 * k8 + 2], za[4 * k8 + 3]};
        wgmma128_rs<1>(d, a, sw128_desc(wb + 2 * nc * kWBox + k8 * 2048, kWBox, 1024), k8);
      }
      wg_commit();
      wg_wait<0>();
      acc_fence(d);
      const int c0 = nc ? 0 : 128;  // the staging tile's columns
      if (nc) {  // boxes 0-1 are free once zeta's store has read them
        if (lead) bulk_wait_read1();
        wg_sync(cw);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(st + sw_off(ra + 8 * h, c0 + 8 * j + 2 * q)) =
              pack2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      fence_async_smem();
      wg_sync(cw);
      if (lead) {
        tma_store(&m.dx0, sa0 + (c0 >> 6) * kBBox, 128 * nc, r0);
        tma_store(&m.dx0, sa0 + ((c0 >> 6) + 1) * kBBox, 128 * nc + 64, r0);
        bulk_commit();
      }
    }
    {
      float d[32];
      wg_fence();
#pragma unroll
      for (int k8 = 0; k8 < 8; ++k8) {
        const uint32_t a[4] = {za[4 * k8], za[4 * k8 + 1], za[4 * k8 + 2], za[4 * k8 + 3]};
        wgmma64_rs<1>(d, a, sw128_desc(wb + 4 * kWBox + k8 * 2048, kWBox, 1024), k8);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(d);
      // The span's slot (read above) takes dx1 in its own layout.
      bf16* d1s = reinterpret_cast<bf16*>(st + kBX0);
      bf16* dx1 = static_cast<bf16*>(p.dx1) + static_cast<size_t>(r0) * p.d1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = ra + 8 * h, c = 8 * j + 2 * q + e;
            if (c >= p.d1) continue;
            const bf16 v = __float2bfloat16_rn(d[4 * j + 2 * h + e]);
            if (whole)
              d1s[row * p.d1 + c] = v;
            else if (r0 + row < p.M)
              dx1[row * p.d1 + c] = v;
          }
      if (whole) {
        fence_async_smem();
        wg_sync(cw);
        if (lead) {
          bulk_store(dx1, sa0 + kBX0, kBRows * p.d1 * 2);
          bulk_commit();
        }
      }
    }
    if (lead) bulk_wait_read();
    wg_sync(cw);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (BWD) head_partial(p, hacc, ctid);
}

// ------------------------------------- f32: three TF32 passes on wgmma

// Tile t of the CTA's walk is rows 128 t, 64 a consumer warpgroup. The
// producer (thread 0) fills the ring in the consumers' order: the 9
// slices of the layer's K (the 8th's A the tile's d1-column span and head
// cotangents by bulk copies, or nothing when the tile is partial), then in
// the backward dx's 3 x 4 slices of W1^T's parts.
template <bool BWD>
__global__ void __launch_bounds__(kWgThreads, 1)
    dir1_f32_kernel(const __grid_constant__ Params p, const __grid_constant__ FMaps m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* swh = reinterpret_cast<float*>(smem + kFStages * kFStage);
  float* sb = swh + kHf * kWidth;
  float* sbh = sb + kWidth;
  float* hacc = sbh + 4;
  const uint32_t full = smem_u32(hacc + 8 * kParts), empty = full + 8 * kFStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const uint32_t x1b = kFRows * p.d1 * 4;

  if (warp < 4) {
    reg_dealloc<kProdRegs>();
    if (tid == 0) {
      Ring r{smem_u32(smem), full, empty, kFStages, 0, 0u};
      const uint32_t hbb = BWD ? kFRows * p.hf * 4 : 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int r0 = t * kFRows;
        const bool whole = r0 + kFRows <= p.M;
        for (int kb = 0; kb < kKin / 32; ++kb) {
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kFStage;
          const bool x0 = kb < kD0 / 32;
          mbar_expect_tx(f, (x0 ? kFSlot : (whole ? x1b + hbb : 0)) + 2 * kFSlot);
          if (x0) {
            tma_load(dst, &m.x0, f, 32 * kb, r0);
          } else if (whole) {
            bulk_load(dst, static_cast<const float*>(p.x1) + static_cast<size_t>(r0) * p.d1, x1b, f);
            if (BWD) bulk_load(dst + x1b, p.hbar + static_cast<size_t>(r0) * p.hf, hbb, f);
          }
          tma_load(dst + kFSlot, &m.wh, f, 32 * kb, 0);
          tma_load(dst + 2 * kFSlot, &m.wl, f, 32 * kb, 0);
          r.advance();
        }
        for (int nc = 0; BWD && nc < kKin / kFDxN; ++nc)
          for (int ks = 0; ks < kWidth / 32; ++ks) {
            mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
            const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kFStage;
            mbar_expect_tx(f, 2 * kFDxN * 128);
            tma_load(dst + kFSlot, &m.th, f, 32 * ks, kFDxN * nc);
            tma_load(dst + 2 * kFSlot, &m.tl, f, 32 * ks, kFDxN * nc);
            r.advance();
          }
      }
    }
    return;
  }

  reg_alloc<kConsRegs>();
  const int ctid = tid - 128, cw = ctid >> 7, cwarp = (ctid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  load_head<float>(p, swh, sb, sbh, hacc, ctid);
  float* ha = hacc + (ctid >> 5) * kParts;
  Ring r{smem_u32(smem), full, empty, kFStages, 0, 0u};
  uint32_t h0[4], l0[4], h1[4], l1[4];
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int r0 = t * kFRows, ra = 64 * cw + 16 * cwarp + g;
    const bool whole = r0 + kFRows <= p.M;
    const bool va = r0 + ra < p.M, vb = r0 + ra + 8 < p.M;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kb = 0; kb < kKin / 32; ++kb) {
      mbar_wait(r.full + 8 * r.stage, r.phase);
      const unsigned char* st = smem + r.stage * kFStage;
      const bool x0 = kb < kD0 / 32;
      const float* xs = whole ? reinterpret_cast<const float*>(st)
                              : static_cast<const float*>(p.x1) + static_cast<size_t>(r0) * p.d1;
      const uint32_t bh = r.base + r.stage * kFStage + kFSlot, bl = bh + kFSlot;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t(&hi)[4] = (kk & 1) ? h1 : h0;
        uint32_t(&lo)[4] = (kk & 1) ? l1 : l0;
        if (kk == 0) {  // the previous slice's products are done: add them
          wg_wait<0>();
          if (kb > 0) {
            if (lane == 0) mbar_arrive(r.empty + 8 * prev);
            acc_fence(part);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] += part[i];
          }
        } else {
          wg_wait<1>();
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = 16 * cwarp + g + 8 * (e & 1), c = 8 * kk + q + 4 * (e >> 1);
          float v;
          if (x0)
            v = *reinterpret_cast<const float*>(st + cw * (kFSlot / 2) + f32_off(rr, c));
          else
            v = c < p.d1 && ((e & 1) ? vb : va) ? xs[(64 * cw + rr) * p.d1 + c] : 0.f;
          split_tf32(v, hi[e], lo[e]);
        }
        wg_fence();
        mma3<128>(part, hi, lo, sw128_desc(bh + 32 * kk, 16, 1024),
                  sw128_desc(bl + 32 * kk, 16, 1024), kk);
        wg_commit();
      }
      prev = r.stage;
      r.advance();
    }
    wg_wait<0>();
    float hb[2][kHf];
    if (BWD) {
      // From the last slice's stage (or device memory for a partial tile):
      // the rows' head cotangents, and the segment zero-padded to 32
      // columns (thread 32 w + l of the consumers: row 16 w + l / 2, the
      // half l % 2: its warp's own rows).
      const unsigned char* st = smem + prev * kFStage;
      const float* xs = whole ? reinterpret_cast<const float*>(st)
                              : static_cast<const float*>(p.x1) + static_cast<size_t>(r0) * p.d1;
      const float* hs = whole ? reinterpret_cast<const float*>(st + x1b)
                              : p.hbar + static_cast<size_t>(r0) * p.hf;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < kHf; ++k)
          hb[h][k] = k < p.hf && (h ? vb : va) ? hs[(ra + 8 * h) * p.hf + k] : 0.f;
      const int row = ctid >> 1, half = ctid & 1;
      if (r0 + row < p.M) {
        float w[16];
#pragma unroll
        for (int c = 0; c < 16; ++c)
          w[c] = 16 * half + c < p.d1 ? xs[row * p.d1 + 16 * half + c] : 0.f;
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(p.x1p) +
                                                static_cast<size_t>(r0 + row) * 32 + 16 * half);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dst[c] = make_float4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
      }
      __syncwarp();
    }
    if (lane == 0) mbar_arrive(r.empty + 8 * prev);
    acc_fence(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];

    if (!BWD) {
      head_forward(acc, p, swh, sb, sbh, r0 + ra, q, false);
      continue;
    }
    head_backward(acc, hb, swh, sb, ha, g, lane, false);
    float* z = static_cast<float*>(p.z);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + ra + 8 * h;
        if (row < p.M)
          *reinterpret_cast<float2*>(z + static_cast<size_t>(row) * kWidth + 8 * j + 2 * q) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    // dx = zeta W1 in 3 column blocks of 96: A = zeta from registers (k8
    // step j: columns 8 j + 2 q, 8 j + 2 q + 1 in slots q, q + 4; W1^T's
    // parts come with the hidden units permuted to match), B = W1^T's
    // [96][32] slices. Its K is the width, 128: one accumulator set over
    // its 16 k8 steps (48 truncating additions, a few 1e-6 of the largest
    // term) against the slice sums that K = 288 (the layer) takes.
    float* dx0 = static_cast<float*>(p.dx0);
    float* dx1 = static_cast<float*>(p.dx1);
#pragma unroll 1
    for (int nc = 0; nc < kKin / kFDxN; ++nc) {
      float dacc[48];
#pragma unroll
      for (int ks = 0; ks < kWidth / 32; ++ks) {
        mbar_wait(r.full + 8 * r.stage, r.phase);
        const uint32_t bh = r.base + r.stage * kFStage + kFSlot, bl = bh + kFSlot;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t(&hi)[4] = (kk & 1) ? h1 : h0;
          uint32_t(&lo)[4] = (kk & 1) ? l1 : l0;
          // The products two k8 steps back are done (their fragments' set
          // is free); at a slice's second step those are the previous
          // slice's last, so its stage goes back without draining.
          wg_wait<1>();
          if (kk == 1 && ks > 0 && lane == 0) mbar_arrive(r.empty + 8 * prev);
          const int j = 4 * ks + kk;
          split_tf32(acc[4 * j], hi[0], lo[0]);
          split_tf32(acc[4 * j + 2], hi[1], lo[1]);
          split_tf32(acc[4 * j + 1], hi[2], lo[2]);
          split_tf32(acc[4 * j + 3], hi[3], lo[3]);
          wg_fence();
          mma3<96>(dacc, hi, lo, sw128_desc(bh + 32 * kk, 16, 1024),
                   sw128_desc(bl + 32 * kk, 16, 1024), ks | kk);
          wg_commit();
        }
        prev = r.stage;
        r.advance();
      }
      wg_wait<0>();
      if (lane == 0) mbar_arrive(r.empty + 8 * prev);
      reg_fence(dacc);
#pragma unroll
      for (int j = 0; j < kFDxN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + ra + 8 * h, c = kFDxN * nc + 8 * j + 2 * q;
          if (row >= p.M) continue;
          const float v0 = dacc[4 * j + 2 * h], v1 = dacc[4 * j + 2 * h + 1];
          if (c < kD0) {
            *reinterpret_cast<float2*>(dx0 + static_cast<size_t>(row) * kD0 + c) =
                make_float2(v0, v1);
          } else {
            float* d1r = dx1 + static_cast<size_t>(row) * p.d1;
            if (c - kD0 < p.d1) d1r[c - kD0] = v0;
            if (c + 1 - kD0 < p.d1) d1r[c + 1 - kD0] = v1;
          }
        }
    }
  }
  if (BWD) head_partial(p, hacc, ctid);
}

// hi, lo [rows][cols] = the TF32 parts of v [rows][cols]; with perm8 the
// columns of every 8 are taken as 0, 2, 4, 6, 1, 3, 5, 7 (W1^T's for dx:
// the order of zeta's A fragments).
__global__ void __launch_bounds__(256) split_kernel(int rows, int cols, const float* v, float* hi,
                                                    float* lo, int perm8) {
  const int n = rows * cols;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    const int c = i % cols, s = c & 7;
    const int src = perm8 ? (c & ~7) + (s < 4 ? 2 * s : 2 * (s - 4) + 1) : c;
    uint32_t h, l;
    split_tf32(v[i - c + src], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

inline bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

// A tensor map of a row-major f32 matrix [rows][cols] (row stride `ld`
// elements) in boxes of box_rows x 32 columns, 128-byte swizzled; reads
// past the matrix give zeros. Returns false on failure.
inline bool make_map_f32(CUtensorMap* map, const void* base, int cols, int rows, int ld,
                         int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr || cols <= 0 || rows <= 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The CTAs of a launch: one an SM, at most one a tile.
inline int grid_of(int tiles) {
  const int sms = sm_count();
  return sms <= 0 ? 0 : (tiles < sms ? tiles : sms);
}

template <typename Kernel, typename Maps>
inline int launch(Kernel kernel, int smem, const Params& p, const Maps& m, int nparts,
                  cudaStream_t s) {
  const int grid = grid_of(p.tiles);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (nparts < grid) return static_cast<int>(cudaErrorInvalidValue);  // hpart too small
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kWgThreads, smem, s>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// Checks what both directions take and launches: bf16 (bf = 1; w_lo, wt,
// wt_lo null) or f32 (w, w_lo W1's TF32 parts [128][288]; the backward's
// wt, wt_lo W1^T's [288][128], its hidden units permuted by
// refnerf_dir1_split's perm8).
inline int run(bool bwd, int bf, const Params& p, const void* x0, const void* w, const void* w_lo,
               const void* wt, const void* wt_lo, int nparts, cudaStream_t s) {
  const bool f32 = !bf;
  if (p.M <= 0 || p.d1 < 1 || p.d1 > kD1Max || p.hf < 1 || p.hf > kHf || !x0 || !p.x1 || !w ||
      !p.b || !p.wh || !aligned16(x0) || !aligned16(p.x1) || !aligned16(w) ||
      f32 != (w_lo != nullptr) || (f32 && !aligned16(w_lo)) || (!bwd && (!p.rgb || !p.bh)) ||
      (bwd && (!p.hbar || !aligned16(p.hbar) || !p.dx0 || !p.dx1 || !p.z || !p.x1p ||
               !aligned16(p.dx0) || !aligned16(p.dx1) || !aligned16(p.z) || !aligned16(p.x1p) ||
               !p.hpart ||
               f32 != (wt != nullptr) || f32 != (wt_lo != nullptr) ||
               (f32 && (!aligned16(wt) || !aligned16(wt_lo))))))
    return static_cast<int>(cudaErrorInvalidValue);
  Params q = p;
  if (bf) {
    BMaps m;
    memset(&m, 0, sizeof(m));
    if (!make_map(&m.x0, x0, kD0, p.M, kD0, kBRows) ||
        !make_map(&m.w, w, kKin, kWidth, kKin, kWidth) ||
        (bwd && (!make_map(&m.z, p.z, kWidth, p.M, kWidth, kBRows) ||
                 !make_map(&m.dx0, p.dx0, kD0, p.M, kD0, kBRows))))
      return static_cast<int>(cudaErrorInvalidValue);
    q.tiles = (p.M + kBRows - 1) / kBRows;
    return bwd ? launch(dir1_bf16_kernel<true>, kBSmem, q, m, nparts, s)
               : launch(dir1_bf16_kernel<false>, kBSmem, q, m, grid_of(q.tiles), s);
  }
  FMaps m;
  memset(&m, 0, sizeof(m));
  bool ok = make_map_f32(&m.x0, x0, kD0, p.M, kD0, kFRows) &&
            make_map_f32(&m.wh, w, kKin, kWidth, kKin, kWidth) &&
            make_map_f32(&m.wl, w_lo, kKin, kWidth, kKin, kWidth);
  if (bwd)
    ok = ok && make_map_f32(&m.th, wt, kWidth, kKin, kWidth, kFDxN) &&
         make_map_f32(&m.tl, wt_lo, kWidth, kKin, kWidth, kFDxN);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  q.tiles = (p.M + kFRows - 1) / kFRows;
  return bwd ? launch(dir1_f32_kernel<true>, kFSmem, q, m, nparts, s)
             : launch(dir1_f32_kernel<false>, kFSmem, q, m, grid_of(q.tiles), s);
}

// Plain C entries for ctypes: each returns the cudaError_t of its launch (0
// on success; an argument or a tensor map it refuses gives
// cudaErrorInvalidValue), allocates nothing and does not synchronise; all
// run on `stream`. (C linkage inside the namespace: the names are the C
// ones.)

// K2: rgb [M][hf] f32 of the trunk on x0 [M][256] and x1 [M][d1] (compute
// dtype, contiguous, 16-byte aligned), W1 [128][288] (f32: its TF32 parts),
// b1 [128], the head wh [hf][128] and bh [hf].
extern "C" int refnerf_dir1_fwd(int bf, int M, int d1, int hf, const void* x0, const void* x1,
                                const void* w, const void* w_lo, const void* b, const float* wh,
                                const float* bh, float* rgb, void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  p.M = M;
  p.d1 = d1;
  p.hf = hf;
  p.x1 = x1;
  p.b = b;
  p.wh = wh;
  p.bh = bh;
  p.rgb = rgb;
  return run(false, bf, p, x0, w, w_lo, nullptr, nullptr, 0, static_cast<cudaStream_t>(stream));
}

// K5 with the segments' cotangents: dx0 [M][256] and dx1 [M][d1] (compute
// dtype) from rgb's cotangent hbar [M][hf]; zeta [M][128] and x1 padded to
// [M][32] (compute dtype) for the weight gradient; hpart [nparts][387] the
// head's gradients a CTA (dwh [3][128] | dbh [3], zeros past hf), at most
// nparts CTAs (`refnerf_dir1_parts`).
extern "C" int refnerf_dir1_bwd(int bf, int M, int d1, int hf, const void* x0, const void* x1,
                                const void* w, const void* w_lo, const void* wt,
                                const void* wt_lo, const void* b, const float* wh,
                                const float* hbar, void* dx0, void* dx1, void* z, void* x1p,
                                float* hpart, int nparts, void* stream) {
  Params p;
  memset(&p, 0, sizeof(p));
  p.M = M;
  p.d1 = d1;
  p.hf = hf;
  p.x1 = x1;
  p.b = b;
  p.wh = wh;
  p.hbar = hbar;
  p.dx0 = dx0;
  p.dx1 = dx1;
  p.z = z;
  p.x1p = x1p;
  p.hpart = hpart;
  return run(true, bf, p, x0, w, w_lo, wt, wt_lo, nparts, static_cast<cudaStream_t>(stream));
}

// The head partials (CTAs) a backward of M rows writes on this card.
extern "C" int refnerf_dir1_parts(int bf, int M) {
  if (M <= 0) return 0;
  const int rows = bf ? kBRows : kFRows;
  return grid_of((M + rows - 1) / rows);
}

// hi, lo [rows][cols] = the TF32 parts of v (f32), the columns of every 8
// permuted where perm8 (cols a multiple of 8).
extern "C" int refnerf_dir1_split(int rows, int cols, const float* v, float* hi, float* lo,
                                  int perm8, void* stream) {
  if (rows <= 0 || cols <= 0 || (perm8 && cols % 8) || !v || !hi || !lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = rows * cols, blocks = (n + 255) / 256;
  split_kernel<<<blocks < 1024 ? blocks : 1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, cols, v, hi, lo, perm8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dir1

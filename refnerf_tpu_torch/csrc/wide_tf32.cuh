// The pieces of three TF32 passes of wgmma fed by TMA that the wide-input
// spatial trunk's f32 kernels share (trunk_wide_tf32.cu's forward K3,
// trunk_wide_bwd_tf32.cu's backward K4): the trunk's constants, the TF32
// split, the m64n128k8 and m64n32k8 products, the layouts of the swizzled
// boxes and of the activation tile, a consumer's view of the ring of weight
// slices, the product of a tile with the ring's next panels, the tile's
// stores, the relu' bits and the host's tensor maps of f32 matrices. Each
// file defines PHASE_SYNC() before it includes this one.

#pragma once

#include <string.h>

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

}  // namespace wtf

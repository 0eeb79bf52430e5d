// Building blocks of the f32 trunk kernels for Hopper (trunk_fwd_f32.cu and
// trunk_bwd_f32.cu at widths 256 and 128): register-blocked FMA products
// fed by a TMA ring of weight slices, on k-major shared-memory tiles.
//
// Each product acc[64][256] = A[64][K] B[K][256] is an outer product over K:
// each of the 256 consumer threads owns an 8 x 8 block of outputs (rows
// R(i) = rb + i % 4 + 16 (i / 4), columns C(j) = cb + j % 4 + 32 (j / 4); a
// warp 32 rows x 64 columns), and each k step reads its 8 values of A and of
// B as four LDS.128 for 64 FFMA. Every operand sits with the contraction
// index outermost ("k-major"): the activation and input tiles
// [feature][kLD] (64 samples padded to kLD = 68 floats, so that neither an
// epilogue's column stores nor a product's row loads conflict in the
// banks), and the weights as slices of 16 contraction rows by 256 columns
// (16 KB), which the producer warp loads by TMA from one tensor map a layer
// and pack. Every product runs in full f32 on the FMA pipes (no TF32).
// At width W = 128 a CTA holds two 64-sample tiles as one k-major tile of R
// = 128 samples (rows padded to R + 4 floats), its 8 consumer warps 4 row
// quarters x 2 column halves, and the slices are [16][128] (8 KB): the same
// 8 x 8 block a thread and 4 LDS.128 for 64 FFMA.

#pragma once

#include <string.h>

#include "hopper_tma.cuh"

namespace {

constexpr int kSD = 16;                  // contraction rows of a weight slice
constexpr int kSliceF = kSD * kW * 4;    // bytes of a [16][256] f32 slice
constexpr int kLD = kRows + 4;           // floats a row of a k-major tile
// At width W: bytes of a [16][W] slice, a CTA's rows R and its tiles' row
// stride R + 4.
template <int W> constexpr int kSliceFW = kSD * W * 4;
template <int W> constexpr int kRowsW = kRows * kTiles<W>;
template <int W> constexpr int kLDW = kRowsW<W> + 4;

// One tensor map a layer and pack, and the ring's depth.
struct MapsF32 {
  CUtensorMap w[kMaxDepth];   // layer l of `w`: [W][K_l], box W x 16
  CUtensorMap wt[kMaxDepth];  // layer l of `wt`: [K_l][W], box W x 16
  CUtensorMap wc;             // a head's pack (the backward's wc [HC][W], the
                              // forward's wc^T [W][HC]), box 256 x 16
  int stages;                 // of the ring
};

// A thread's 8 x 8 block: element (i, j) at row rb + R(i), column cb + C(j).
__device__ __forceinline__ int row_of(int i) { return (i & 3) + 16 * (i >> 2); }
__device__ __forceinline__ int col_of(int j) { return (j & 3) + 32 * (j >> 2); }

using Block = float[8][8];

// acc = A B over the next K / kSD slices of the ring (`ring` its generic
// address): A's contraction rows k < n0 from the k-major tile a0, the rest
// from a1 (the skip layer's [activation | input]), B [16][W] slices.
// Consumer warps only.
template <int W = kW>
__device__ __forceinline__ void product(Block& acc, const float* a0, int n0, const float* a1,
                                        int K, Ring& r, const float* ring, int rb, int cb) {
  constexpr int LD = kLDW<W>;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ns = K / kSD;
  for (int s = 0; s < ns; ++s) {
    const int k0 = s * kSD;
    const float* a = (k0 < n0 ? a0 + k0 * LD : a1 + (k0 - n0) * LD) + rb;
    const float* b = ring + r.stage * (kSD * W) + cb;
    mbar_wait(r.full + 8 * r.stage, r.phase);
#pragma unroll
    for (int kk = 0; kk < kSD; ++kk) {
      const float4 a0v = *reinterpret_cast<const float4*>(a + kk * LD);
      const float4 a1v = *reinterpret_cast<const float4*>(a + kk * LD + 16);
      const float4 b0v = *reinterpret_cast<const float4*>(b + kk * W);
      const float4 b1v = *reinterpret_cast<const float4*>(b + kk * W + 32);
      const float av[8] = {a0v.x, a0v.y, a0v.z, a0v.w, a1v.x, a1v.y, a1v.z, a1v.w};
      const float bv[8] = {b0v.x, b0v.y, b0v.z, b0v.w, b1v.x, b1v.y, b1v.z, b1v.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * r.stage);
    r.advance();
  }
}

// A product of at most half a slice's columns (the forward's 128-wide
// bottleneck and K3's u_x at width 256; the backward's last dx pass at
// width 128): acc = A B[:, :W / 2] over the next K / kSD slices of the ring,
// A the k-major tile a0. Each thread owns 8 rows (as `product`'s block) x 4
// columns cbh + j, and reads 3 LDS.128 a k step for 32 FFMA: half of
// `product`'s work, which would multiply the zero columns that TMA fills
// past the weights' extent.
using Half = float[8][4];

template <int W = kW>
__device__ __forceinline__ void product_half(Half& acc, const float* a0, int K, Ring& r,
                                             const float* ring, int rb, int cbh) {
  constexpr int LD = kLDW<W>;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int ns = K / kSD;
  for (int s = 0; s < ns; ++s) {
    const float* a = a0 + s * kSD * LD + rb;
    const float* b = ring + r.stage * (kSD * W) + cbh;
    mbar_wait(r.full + 8 * r.stage, r.phase);
#pragma unroll
    for (int kk = 0; kk < kSD; ++kk) {
      const float4 a0v = *reinterpret_cast<const float4*>(a + kk * LD);
      const float4 a1v = *reinterpret_cast<const float4*>(a + kk * LD + 16);
      const float4 b0v = *reinterpret_cast<const float4*>(b + kk * W);
      const float av[8] = {a0v.x, a0v.y, a0v.z, a0v.w, a1v.x, a1v.y, a1v.z, a1v.w};
      const float bv[4] = {b0v.x, b0v.y, b0v.z, b0v.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * r.stage);
    r.advance();
  }
}

// The block into a k-major [features][LD] tile: two 16-byte stores a column.
template <int LD = kLD>
__device__ __forceinline__ void put_tile(float* t, const Block& v, int rb, int cb) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* d = t + (cb + col_of(j)) * LD + rb;
    *reinterpret_cast<float4*>(d) = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    *reinterpret_cast<float4*>(d + 16) = make_float4(v[4][j], v[5][j], v[6][j], v[7][j]);
  }
}

// Loads a thread keeps in flight in the scalar loops over a tile: with one
// CTA an SM no other warps hide their latency.
constexpr int kBatch = 8;

// `product` without its zeroing, on one k-major tile: acc += A B over the
// next K / kSD slices of the ring, A the tile a0. The wide-input instances
// (trunk_fwd_f32.cu `fwd_f32_wide`, trunk_bwd_f32.cu `bwd_f32_wide`) sum a
// layer's input share chunk by chunk with it. Consumer warps only.
__device__ __forceinline__ void product_add(Block& acc, const float* a0, int K, Ring& r,
                                            const float* ring, int rb, int cb) {
  const int ns = K / kSD;
  for (int s = 0; s < ns; ++s) {
    const float* a = a0 + s * kSD * kLD + rb;
    const float* b = ring + r.stage * (kSD * kW) + cb;
    mbar_wait(r.full + 8 * r.stage, r.phase);
#pragma unroll
    for (int kk = 0; kk < kSD; ++kk) {
      const float4 a0v = *reinterpret_cast<const float4*>(a + kk * kLD);
      const float4 a1v = *reinterpret_cast<const float4*>(a + kk * kLD + 16);
      const float4 b0v = *reinterpret_cast<const float4*>(b + kk * kW);
      const float4 b1v = *reinterpret_cast<const float4*>(b + kk * kW + 32);
      const float av[8] = {a0v.x, a0v.y, a0v.z, a0v.w, a1v.x, a1v.y, a1v.z, a1v.w};
      const float bv[8] = {b0v.x, b0v.y, b0v.z, b0v.w, b1v.x, b1v.y, b1v.z, b1v.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * r.stage);
    r.advance();
  }
}

// The wide-input instances stream the trunk input through a k-major tile of
// kChunk columns (35 KB) instead of holding all kin columns (139 KB at 512).
constexpr int kChunk = 128;

// Columns [c0, c0 + kc) of the trunk input [x0 (d0) | x1 (d1) | zeros to kin]
// of the tile's rows into the k-major [kc][kLD] tile t, zero past row n;
// neighbouring threads read neighbouring columns of a row, every load of a
// batch in flight before its stores.
__device__ void load_input_cols(float* t, const float* x0, int d0, const float* x1, int d1,
                                int c0, int kc, int row0, int n) {
  const int total = kRows * kc;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kCons) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons, gr = row0 + i / kc, c = c0 + i % kc, c1 = c - d0;
      v[u] = 0.f;
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
      if (i < total) t[(i % kc) * kLD + i / kc] = v[u];
    }
  }
}

// The trunk input tile of R rows (trunk_common.cuh `load_input`), k-major,
// zero-padded to kin columns and past row n; the IDE block (DIR) at R = 64.
template <bool DIR, int R = kRows>
__device__ void load_input_f32(float* t, const float* x0, int d0, const float* x1, int d1,
                               int kin, int row0, int n, const DirIn& dir) {
  constexpr int LD = R + 4;
  const int dide = DIR ? dir.width() : 0, total = R * kin;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kCons) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons, r = i / kin, c = i % kin, gr = row0 + r, c1 = c - d0 - dide;
      v[u] = 0.f;
      if (i < total && gr < n) {
        if (c < d0)
          v[u] = __ldg(x0 + static_cast<size_t>(gr) * d0 + c);
        else if (c1 >= 0 && c1 < d1)
          v[u] = __ldg(x1 + static_cast<size_t>(gr) * d1 + c1);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons, r = i / kin, c = i % kin;
      if (i < total && !(DIR && c >= d0 && c - d0 - dide < 0)) t[c * LD + r] = v[u];
    }
  }
  if constexpr (DIR) {
    static_assert(R == kRows, "the IDE block fills 64 rows");
    if (dir.p) {  // the IDE block (trunk_common.cuh `ide_fill`), four threads a row
      const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
      const DirSample s = load_dir(dir, row0 + r, n);
      for (int i = q; i < dir.p; i += 4) {
        const Harm h = ide_harmonic(dir, s.rd[0], s.rd[1], s.rd[2], i);
        const float zpat = h.zp * expf(mul(-s.ki, __ldg(dir.sg + i)));
        t[(d0 + i) * kLD + r] = s.live ? h.re * zpat : 0.f;
        t[(d0 + dir.p + i) * kLD + r] = s.live ? h.im * zpat : 0.f;
      }
      if (dir.geo && q == 0) t[(d0 + 2 * dir.p) * kLD + r] = s.live ? s.nd : 0.f;
    }
  }
}

// Width 128 (trunk_fwd_f32.cu, trunk_bwd_f32.cu): the CTA's input tile of R rows (load_input_f32 without the IDE
// block), k-major, zero-padded to kin columns and past row n; x0 in 16-byte
// loads where its rows allow (d0 a multiple of 4, the pointer 16-byte
// aligned). Thread t keeps to row t % R, so the tile's stores do not
// conflict in the banks, and every load of a batch is in flight before its
// stores.
template <int R>
__device__ void load_input_rows(float* t, const float* x0, int d0, const float* x1, int d1,
                                int kin, int row0, int n) {
  constexpr int LD = R + 4;
  int c_lo = 0;  // columns [0, c_lo) come by the 16-byte loads
  if ((d0 & 3) == 0 && (reinterpret_cast<uintptr_t>(x0) & 15) == 0) {
    const int total = R * (d0 / 4);
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kCons) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kCons, gr = row0 + i % R;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && gr < n)
          v[u] = __ldg(reinterpret_cast<const float4*>(x0 + static_cast<size_t>(gr) * d0) + i / R);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kCons, r = i % R, c = 4 * (i / R);
        if (i >= total) continue;
        t[c * LD + r] = v[u].x;
        t[(c + 1) * LD + r] = v[u].y;
        t[(c + 2) * LD + r] = v[u].z;
        t[(c + 3) * LD + r] = v[u].w;
      }
    }
    c_lo = d0;
  }
  const int total = R * (kin - c_lo);
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kCons) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCons, gr = row0 + i % R, c = c_lo + i / R, c1 = c - d0;
      v[u] = 0.f;
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
      if (i < total) t[(c_lo + i / R) * LD + i % R] = v[u];
    }
  }
}

// K7: the tile's lifted means and variances staged in st (2 x [kRows][nb]
// floats), every load in flight at once; ipe_trig then reads them by the
// tile's row from shared memory. Ends with the consumers synchronised.
__device__ Ipe stage_ipe(const Ipe& q, float* st, int row0, int n) {
  const int m = kRows * q.nb;
  for (int i = threadIdx.x; i < 2 * m; i += kCons) {
    const int k = i < m ? i : i - m;
    st[i] = row0 + k / q.nb < n
                ? __ldg((i < m ? q.lm : q.lv) + static_cast<size_t>(row0) * q.nb + k) : 0.f;
  }
  cons_sync();
  return Ipe{st, st + m, q.fold, q.nb};
}

// K7's input tile (trunk_common.cuh `load_ipe`), k-major, from the staged
// lifted means and variances.
__device__ void load_ipe_f32(float* t, const Ipe& q, int F, int kin, int row0, int n) {
  for (int i = threadIdx.x; i < kRows * kin; i += kCons) {
    const int r = i / kin, c = i % kin, gr = row0 + r;
    if (gr < n && c < F) {
      float e, sn, cs;
      ipe_trig(q, r, c, e, sn, cs);
      t[c * kLD + r] = mul(e, sn);
      t[(F + c) * kLD + r] = mul(e, cs);
    } else if (gr >= n || c >= 2 * F) {
      t[c * kLD + r] = 0.f;
    }
  }
}

// A tensor map of a row-major f32 matrix [rows][cols] (row stride `ld`
// elements) in boxes of box_rows x box_cols, unswizzled; reads past the
// matrix give zeros. Returns false on failure.
bool make_map_f32(CUtensorMap* map, const void* base, int cols, int rows, int ld, int box_cols,
                  int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr || cols <= 0 || rows <= 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The per-layer tensor maps of the packs `w` ([W][K_l]) and `wt` ([K_l][W])
// of a width-W trunk of `depth` layers on kin input columns (the skip
// layer's K_l = W + kin), in boxes of W columns x 16 rows; false on failure.
template <int W = kW>
bool make_layer_maps_f32(MapsF32& m, const void* w, const void* wt, int depth, int kin, int skip) {
  size_t off = 0;
  bool ok = true;
  for (int l = 0; l < depth; ++l) {
    const int K = l == 0 ? kin : (l == skip ? W + kin : W);
    ok = ok && make_map_f32(&m.w[l], static_cast<const float*>(w) + off, K, W, K, W, kSD) &&
         make_map_f32(&m.wt[l], static_cast<const float*>(wt) + off, W, K, W, W, kSD);
    off += static_cast<size_t>(W) * K;
  }
  return ok;
}

}  // namespace

// Hopper building blocks of the wgmma/TMA trunk kernels (trunk_fwd_tma.cu,
// trunk_bwd_tma.cu, and the bf16 products of trunk_w1024.cu): the PTX of
// mbarriers, TMA, wgmma (64 x 128 and 64 x 256 tiles) and setmaxnreg, the
// ring of weight slices, the 128-byte-swizzled tile layout, the product of
// a tile with the next slices of the ring, and the host-side tensor maps. The
// trunk width is kW (256) unless a kernel takes it as a template parameter
// W (all four TMA trunk kernels also run at 128). The wide-input
// instances' input fill (`wide_chunk`) is here too.

#pragma once

#include <cuda.h>

#include "trunk_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kW = 256;                  // the widest trunk width
constexpr int kCons = 256;               // consumer threads: two warpgroups
constexpr int kTmaThreads = kCons + 32;  // and one producer warp
constexpr int kBK = 64;                  // K-slice: 64 bf16, one swizzled row
constexpr int kSlice = kW * 128;   // bytes of a [256][64] weight slice
// Bytes of a [W][64] weight slice, and the 64-sample tiles a CTA of a
// width-W kernel holds: one at 256, two at 128, so that a consumer thread
// keeps 64 outputs of each product at either width.
template <int W> constexpr int kSliceW = W * 128;
template <int W> constexpr int kTiles = kW / W;
constexpr int kBlk = kRows * 128;  // bytes of a [64][64] block of a tile
constexpr int kMaxDepth = 8;       // tensor maps a pack (kernel parameter space)
constexpr long long kHang = 1ll << 33;  // cycles (~4 s) before a wait traps
// The widest input of the wide-input instances (trunk_fwd_tma.cu,
// trunk_bwd_tma.cu, trunk_fwd_f32.cu, trunk_bwd_f32.cu), which stream it in
// chunks of columns.
constexpr int kWideKin = 1024;

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cons_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Waits for the phase of parity `parity` to complete; traps (an error, not
// a hang) if that takes seconds, which only a fault can make it do.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > kHang)
      __trap();
  }
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (K-major: the stride is 8 rows,
// 1024 bytes; MN-major: the leading offset steps 64 MN elements, the stride
// 8 K rows).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T on one k16 step, A [64][16] and B [128][16] bf16 from shared
// memory, f32 accumulation; TA / TB: the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A B^T on one k16 step, A [64][16] and B [256][16] bf16 from shared
// memory, f32 accumulation (128 a thread: acc[4 j + 2 h + e] is row
// 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e of the warpgroup's
// 64 x 256 tile); TA / TB: the operand is MN-major (transposed), whose
// 128-byte-swizzled descriptor steps 64 MN elements by its leading offset.
template <int TA, int TB>
__device__ __forceinline__ void wgmma256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}
// acc_fence for the 128 accumulators of wgmma256.
__device__ __forceinline__ void acc_fence256(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Warp-specialised kernels: a producer warpgroup gives up registers that
// its consumer warpgroups take (every warp of a warpgroup runs the same
// one; a multiple of 8 in [24, 256]).
template <int N> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---------------------------------------------------------------------------
// The ring of weight slices: the producer fills stages in order, the
// consumers empty them in the same order.

struct Ring {
  uint32_t base;   // shared address of stage 0
  uint32_t full;   // n mbarriers: the stage has landed
  uint32_t empty;  // n mbarriers: all 8 consumer warps are done with it
  int n;           // stages
  int stage;
  uint32_t phase;
  __device__ void advance() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Byte offset of element (r, c) of a [64][cols] tile in 64-column swizzled
// blocks.
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return static_cast<uint32_t>((c >> 6) * kBlk + r * 128 +
                               ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

struct Tile {
  unsigned char* p;
  __device__ bf16& operator()(int r, int c) const {
    return *reinterpret_cast<bf16*>(p + sw_off(r, c));
  }
};

// acc = A[64][K] B^T with B the next ceil(K / 64) slices of the ring. A's
// K-slices s < n0 are the blocks of a0, the rest those of a1 (the skip
// layer's [activation | input]). At width 256 warpgroup g takes B's rows
// [128 g, 128 g + 128) of each [256][64] slice; at 128 both take the whole
// [128][64] slice, each with the A of its own tile. With `acc_in` acc +=
// (the first slice keeps the accumulators). Consumer warps only.
template <int W = kW>
__device__ __forceinline__ void product(float (&acc)[64], uint32_t a0, int n0, uint32_t a1, int K,
                                        Ring& r, int acc_in = 0) {
  const int wg = threadIdx.x >> 7;
  const int ns = (K + kBK - 1) / kBK;
  int prev = 0;
  wg_fence();
  for (int s = 0; s < ns; ++s) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    const uint32_t a = s < n0 ? a0 + s * kBlk : a1 + (s - n0) * kBlk;
    const uint32_t b = r.base + r.stage * kSliceW<W> + (W == kW ? wg * (kSliceW<W> / 2) : 0);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma128<0, 0>(acc, sw128_desc(a + 32 * kk, 16, 1024), sw128_desc(b + 32 * kk, 16, 1024),
                     s | kk | acc_in);
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
  acc_fence(acc);
}

__device__ __forceinline__ bool bit_at(uint2 m, int i) {
  return ((i < 32 ? m.x >> i : m.y >> (i - 32)) & 1u) != 0;
}

// ---------------------------------------------------------------------------
// The wide-input instances' input: the trunk input [x0 (d0) | x1 (d1) |
// zeros] enters a tile chunk by chunk of columns, each chunk's products
// running while the next chunk lands.

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}
// cp_async_wait with a run-time count of newer groups left pending (at
// most 3 are waited for as 3).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3)
    cp_async_wait<3>();
  else if (n == 2)
    cp_async_wait<2>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// Columns [c0, c0 + cw) of the trunk input of rows [row0, row0 + rows) to
// `buf`, a [64][CW] tile of 64-column swizzled blocks (cw <= CW, a multiple
// of 64); zeros past the segments and past `rows`. Where both segments'
// widths are multiples of 4 and their bases 8-byte aligned, 4 columns are
// one 8-byte cp.async that lands while the thread goes on (a chunk of the
// swizzled layout is 8 columns, and a 4-column half never straddles a
// segment: 8-byte-aligned source and destination); cp_async_wait and a
// barrier then publish it. Else 2-byte loads. nth threads share the work.
template <int CW>
__device__ void wide_chunk(unsigned char* buf, const bf16* x0, int d0, const bf16* x1, int d1,
                           int c0, int cw, int row0, int rows, int tid, int nth) {
  constexpr int Q = CW / 4;  // 4-column pieces of a row
  const int fin = d0 + d1;
  const bool vec = ((d0 | d1) & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(x1)) & 7) == 0;
  for (int i = tid; i < kRows * Q; i += nth) {
    const int r = i / Q, c = 4 * (i % Q), g = c0 + c;
    if (c >= cw) continue;
    unsigned char* dst = buf + sw_off(r, c);
    uint2 v = make_uint2(0u, 0u);
    if (r < rows && g < fin) {
      const size_t gr = static_cast<size_t>(row0 + r);
      if (vec) {
        cp_async8(smem_u32(dst), g < d0 ? x0 + gr * d0 + g : x1 + gr * d1 + (g - d0));
        continue;
      }
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = g + e;
        const bf16 z = from_f<bf16>(0.f);
        const bf16 x = k < d0 ? x0[gr * d0 + k] : (k < fin ? x1[gr * d1 + (k - d0)] : z);
        w[e >> 1] |= static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&x))
                     << (16 * (e & 1));
      }
      v = make_uint2(w[0], w[1]);
    }
    *reinterpret_cast<uint2*>(dst) = v;
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps through the driver entry point (no -lcuda).

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map of a row-major bf16 matrix [rows][cols] (row stride `ld`
// elements) in boxes of box_rows x 64 columns, 128-byte swizzled; reads
// past the matrix give zeros. Returns false on failure.
bool make_map(CUtensorMap* map, const void* base, int cols, int rows, int ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr || cols <= 0 || rows <= 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

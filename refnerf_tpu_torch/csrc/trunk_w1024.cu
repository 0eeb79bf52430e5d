// The width-1024 spatial trunk, layer by layer, forward (K1 at width 1024)
// and first-order backward (K4 at width 1024, without the cotangent of u).
//
// Replaces, for mip-NeRF 360's NeRF MLP (8 x 1024, the skip at layer 5, the
// density head and the 256-wide bottleneck head on 504 IPE columns), the
// Pallas pair of refnerf_tpu/ops/pallas/fused_mlp.py (`_fwd_kernel` :612 and
// `_bwd_kernel` :668). The TPU kernel keeps a block of rows and every layer's
// activation in VMEM; at width 1024 a 64-row tile's activations alone are
// 256 KB in bf16 and 512 KB in f32, past the 227 KB of shared memory an
// H100 CTA may hold, and 64 x 1024 f32 accumulators do not fit in
// registers. So each layer is one product over all rows, its activations
// through device memory (1 GiB a layer in bf16, 2 GiB in f32, at 524,288
// rows), and the work is bounded by the products' operations: 9.05 TFLOP
// forward at 524,288 rows.
//
// Products (C = A B^T over K, "nt": both operands K-contiguous; and the
// weight gradients' C = Z^T X over rows, "tn": both operands row-major). An
// operand may come in two K segments (the skip layer's [activation |
// input], the weight gradient's [h | x]): never concatenated.
//
// bf16 (nt_wgmma_kernel, tn_wgmma_kernel): persistent, one CTA an SM
// walking 128 x 256 output tiles, warp-specialised: a producer warpgroup
// (setmaxnreg down to 40 registers) whose one thread keeps TMA loads of
// 64-deep slices (128-byte swizzle, zeros past the rows) in flight into a
// ring of mbarrier-guarded stages, and two consumer warpgroups (up to 232
// registers) that run wgmma m64n256k16 on 64 rows each, f32 accumulation.
// A 256-wide tile reads the [rows, 1024] input 4 times a layer (the
// bottleneck head once); the tiles run row strip by row strip, the four
// column blocks of a strip side by side, so a strip (256 KB) is read from
// device memory about once and from L2 after. The nt epilogue writes the
// tile in bf16 into a 64 KB swizzled staging tile that a second producer
// thread stores by TMA (rows past the end are not stored) while the
// consumers run the next tile's products; kRev and kHeadBwd find their
// relu' source there, brought in by TMA before the epilogue begins. The tn
// product takes both operands MN-major (transposed) from row-major tiles,
// over a fixed split of the rows into partials; the CTAs of the first
// column block also sum the zeta tile they hold in shared memory into the
// bias gradient's per-partial row, so no kernel reads zeta a second time.
// f32 (nt_tf32_kernel, tn_tf32_kernel): the same persistent shape on
// wgmma m64n128k8 in three TF32 passes. The FMA pipes' 67 TFLOP/s bound a
// full-f32 product at 135 ms forward and 385 ms backward at 524,288 rows;
// the tensor cores run TF32 at 495 TFLOP/s but keep 10 of f32's 23 mantissa
// bits. So each f32 operand v is split on the chip into hi = tf32(v) and lo
// = tf32(v - hi), and a product is lo.hi + hi.lo + hi.hi into one f32
// accumulator set (small terms first; lo.lo, ~2^-22 of the product, is
// dropped): ~21-22 bits of each operand, nearer f32 than the TPU kernel,
// whose MXU truncates f32 operands to bf16 a pass (fused_mlp.py:158-171).
// The bound is three TF32 products: 54.9 ms forward, 156.4 ms backward at
// 524,288 rows. TF32 wgmma reads A and B from shared memory K-major only
// (the transpose bits are 16-bit types' alone), or A from registers: the
// activations (A, 4 GiB a slab) come in f32 by TMA and each consumer
// thread loads its fragment from the swizzled tile and splits it there; the
// weights (B, 33.5 MB) are split once a call (`split_kernel`) into hi and
// lo tensors that come in by TMA like any B operand. The tensor cores add
// into f32 accumulators with truncation (toward zero): on an H100, one
// accumulator set over a layer's 3 x 128 k8 steps read 5e-5 of the largest
// output after 8 layers, 25 times the FMA products', and H8's relu' flips
// then read 1.5 times GRAD_BOUND. So each 32-deep slice's products go into a fresh accumulator
// set that is added into a second in f32, rounded to nearest: two sets of
// 64 a thread, which sets the tile at 128 x 128 (64 rows a consumer
// warpgroup). nt: a 4-stage ring of [128][32] A, B hi and B lo slices (48
// KB a stage), the epilogue from the accumulators straight to device
// memory (no staging tile fits beside the ring). tn: dW = Z^T X over rows,
// both row-major (MN-major); Z (the gradient's 128 rows a tile) comes
// through registers, loaded transposed from its row-major tile, and the
// producer warpgroup's three other warps transpose X's [32][128] slice into
// K-major hi and lo tiles (two buffers); the bias sums come from the Z
// values the consumers load, as in bf16.
//
// Epilogues (nt), each element in the Pallas order of casts:
//   kRelu   h = relu(cdt(cdt(acc) + cdt(bias)))       a trunk layer
//   kBias   c = cdt(cdt(acc) + cdt(bias))             the bottleneck head
//   kRev    zeta' = relu'(h_prev) * cdt(acc)          the reverse product
//   kHeadBwd zeta = relu'(y) * cdt(cdt(acc) + cdt(sbar wd))  the heads'
//                                                     backward

// The forward: one nt product a layer, h_l = relu(cdt(h_{l-1} W_l^T) + b_l)
// over all rows, the skip layer reading [h | x] as two K segments; the
// bottleneck head as one more product (kBias); sigma, an f32 dot product of
// y, in `sigma_kernel`. Bounded by the products' operations (9.05 TFLOP at
// 524,288 rows: 9.16 ms in bf16 on the tensor cores, 54.9 ms in f32 as three
// TF32 passes, 135 ms were it full f32 on the FMA pipes); sigma reads y
// once.
//
// The backward, per slab of rows: the activations recomputed with the
// forward's nt products (the kernels keep their inputs, not their
// activations), the heads' backward (kHeadBwd: zeta of the last layer from
// the bottleneck's and sigma's cotangents), and layer by layer downwards
// the weight gradient dW_l = zeta_l^T [h_{l-1} | x] (the tn product, split
// over rows into partials, with the bias gradient's partials), and
// zeta_{l-1} (kRev). Every sum over rows is a fixed-order sum of per-CTA
// partials (trunk_bwd.cu's `refnerf_reduce`, no atomics), so a gradient does
// not depend on the schedule and a resumed run stays bit for bit. Bounded
// by the products' operations: 25.8 TFLOP at 524,288 rows (recomputation
// not counted), 26.1 ms in bf16, 156.4 ms in f32 as three TF32 passes (385
// ms full f32 on the FMA pipes).
//
// The wrappers (ops/fused_mlp.py `_w1024_forward`, `_w1024_backward`)
// allocate every buffer and sequence the launches on PyTorch's current
// stream.

#include <string.h>

#include "hopper_tma.cuh"

namespace w1024 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // sigma, the column sums, the weights' split

// bf16: 128 x 256 output tiles (64 rows a consumer warpgroup), 64-deep
// slices of 128-byte-swizzled rows: [128][64] of A (or of Z^T's two
// [64][64] boxes) and [256][64] of B (X^T's four boxes) a stage.
constexpr int kWgThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kTM = 128;
constexpr int kTN = 256;
constexpr int kOpA = kTM * 128;        // 16,384 B
constexpr int kStage = kOpA + kTN * 128;  // 49,152 B
constexpr int kNtStages = 3;
constexpr int kTnStages = 4;
constexpr int kOut = kTM * kTN * 2;    // the nt staging tile, 65,536 B
constexpr int kOutBox = kTM * 128;     // one [128][64] box of it
constexpr int kZBox = 64 * 128;        // a [64 rows][64 features] box
constexpr int kProdRegs = 40;   // registers a producer thread keeps
constexpr int kConsRegs = 232;  // and a consumer thread may take

// Dynamic shared memory of each product (fused_mlp.kernel_smem mirrors it):
// 1 KB to align the swizzled tiles, the ring, (nt) the staging tile, the
// mbarriers, (tn) the bias sums' two halves.
constexpr int kNtSmem = 1024 + kNtStages * kStage + kOut + 8 * (2 * kNtStages + 2);  // 214,080 B
constexpr int kTnSmem = 1024 + kTnStages * kStage + 8 * 2 * kTnStages + 2 * kTM * 4;  // 198,720 B

// f32 (three TF32 passes): 32-deep slices (one 128-byte swizzled row of
// f32); 128 x 128 tiles of both products, 64 rows a consumer warpgroup
// (nt: output rows; tn: gradient rows), one m64n128 accumulator set summed
// slice by slice into a second.
constexpr int kFK = 32;
constexpr int kFM = 128;
constexpr int kFN = 128;
constexpr int kFBox = 32 * 128;        // a [32][32] f32 box, 4,096 B
constexpr int kFA = kFM * 128;         // [128][32] of A, or Z's 4 boxes: 16,384 B
constexpr int kFB = kFN * 128;         // [128][32] of B (hi or lo), or X's 4 boxes: 16,384 B
constexpr int kFNtStage = kFA + 2 * kFB;  // 49,152 B
constexpr int kFNtStages = 4;
constexpr int kFTnStage = kFA + kFB;   // Z and X: 32,768 B
constexpr int kFTnStages = 4;
constexpr int kFXt = 2 * kFB;          // X^T's hi and lo tiles, [128][32] each
// Dynamic shared memory (fused_mlp.kernel_smem mirrors it): 1 KB to align,
// the ring, (tn) two X^T buffers, the mbarriers (full, empty; tn also the
// X^T buffers' two each).
constexpr int kF32NtSmem = 1024 + kFNtStages * kFNtStage + 8 * 2 * kFNtStages;  // 197,696 B
constexpr int kF32TnSmem = 1024 + kFTnStages * kFTnStage + 2 * kFXt + 8 * (2 * kFTnStages + 4);  // 197,728 B

enum Epi { kRelu = 0, kRev = 1, kHeadBwd = 2, kBias = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Round to the compute dtype and back.
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- nt product

// C [M][N] = epilogue(A [M][k0 + k1] B [N][k0 + k1]^T): A's columns [0, k0)
// from a0, the rest from a1; B's row n is the weight of output n.
struct NtParams {
  int M, N;
  const void* a0;
  int lda0, k0;
  const void* a1;
  int lda1, k1;
  const void* b;
  const void* b_lo;  // f32: B's TF32 low part (b its high part)
  int ldb;
  const void* bias;  // [N] cdt (kRelu, kBias)
  const void* act;   // [M][ld_act] cdt: relu' source (kRev, kHeadBwd)
  int ld_act;
  const float* sb;   // [M] sigma's cotangent (kHeadBwd), or null
  const float* wd;   // [N] the density head (kHeadBwd)
  void* out;         // [M][ldo] cdt
  int ldo;
};

// ------------------------------------------------ bf16: wgmma fed by TMA

// Byte offset of element (r, c) of the [128][256] staging tile: four
// [128][64] boxes, each 128-byte swizzled as TMA writes and reads it.
__device__ __forceinline__ uint32_t out_off(int r, int c) {
  return static_cast<uint32_t>((c >> 6) * kOutBox + r * 128 +
                               ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

struct NtMaps {
  CUtensorMap a0, a1, b, act, out;  // boxes [128][64], b's [256][64]
};

struct NtTma {
  int M, nk0, nk, tiles_n, tiles;  // K-slices of a0, of both; column blocks; tiles
  const bf16* bias;                // [N] (kRelu, kBias)
  const float* sb;                 // [M] sigma's cotangent (kHeadBwd), or null
  const float* wd;                 // [N] the density head (kHeadBwd)
};

// C [M][N] = epilogue(A [M][k0 + k1] B [N][k0 + k1]^T), tile t of the
// grid's walk at rows 128 (t / tiles_n), columns 256 (t % tiles_n).
// Threads 0-127: the producer warpgroup (thread 0 the operand ring, thread
// 32 the staging tile: the previous tile's TMA store, then this tile's
// relu' source or a bare arrival on `ready`); 128-383: the consumers.
template <int MODE>
__global__ void __launch_bounds__(kWgThreads, 1)
    nt_wgmma_kernel(const __grid_constant__ NtTma p, const __grid_constant__ NtMaps m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* out = smem + kNtStages * kStage;
  const uint32_t full = smem_u32(out + kOut), empty = full + 8 * kNtStages;
  const uint32_t ready = empty + 8 * kNtStages, done = ready + 8;
  constexpr bool kAct = MODE == kRev || MODE == kHeadBwd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kNtStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons / 32);
    }
    mbar_init(ready, 1);
    mbar_init(done, kCons / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    reg_dealloc<kProdRegs>();
    if (tid == 0) {
      Ring r{smem_u32(smem), full, empty, kNtStages, 0, 0u};
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int m0 = (t / p.tiles_n) * kTM, n0 = (t % p.tiles_n) * kTN;
        for (int kb = 0; kb < p.nk; ++kb) {
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kStage;
          mbar_expect_tx(f, kStage);
          if (kb < p.nk0)
            tma_load(dst, &m.a0, f, kb * 64, m0);
          else
            tma_load(dst, &m.a1, f, (kb - p.nk0) * 64, m0);
          tma_load(dst + kOpA, &m.b, f, kb * 64, n0);
          r.advance();
        }
      }
    } else if (tid == 32) {
      const uint32_t o = smem_u32(out);
      int it = 0, pm = 0, pn = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
        const int m0 = (t / p.tiles_n) * kTM, n0 = (t % p.tiles_n) * kTN;
        if (it > 0) {
          mbar_wait(done, (it - 1) & 1);
          for (int q = 0; q < kTN / 64; ++q) tma_store(&m.out, o + q * kOutBox, pn + 64 * q, pm);
          bulk_commit();
          bulk_wait_read();
        }
        if (kAct) {
          mbar_expect_tx(ready, kOut);
          for (int q = 0; q < kTN / 64; ++q)
            tma_load(o + q * kOutBox, &m.act, ready, n0 + 64 * q, m0);
        } else {
          mbar_arrive(ready);
        }
        pm = m0;
        pn = n0;
      }
      mbar_wait(done, (it - 1) & 1);
      for (int q = 0; q < kTN / 64; ++q) tma_store(&m.out, o + q * kOutBox, pn + 64 * q, pm);
      bulk_commit();
      bulk_wait();
    }
    return;
  }

  reg_alloc<kConsRegs>();
  const int ctid = tid - 128, cw = ctid >> 7, cwarp = (ctid >> 5) & 3;
  Ring r{smem_u32(smem), full, empty, kNtStages, 0, 0u};
  float acc[128];
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
    const int m0 = (t / p.tiles_n) * kTM, n0 = (t % p.tiles_n) * kTN;
    int prev = 0;
    wg_fence();
    for (int kb = 0; kb < p.nk; ++kb) {
      mbar_wait(r.full + 8 * r.stage, r.phase);
      const uint32_t a = r.base + r.stage * kStage + cw * (kOpA / 2);
      const uint32_t b = r.base + r.stage * kStage + kOpA;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma256<0, 0>(acc, sw128_desc(a + 32 * kk, 16, 1024), sw128_desc(b + 32 * kk, 16, 1024),
                       kb | kk);
      wg_commit();
      if (kb > 0) {
        wg_wait<1>();
        if (lane == 0) mbar_arrive(r.empty + 8 * prev);
      }
      prev = r.stage;
      r.advance();
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(r.empty + 8 * prev);
    acc_fence256(acc);

    // The epilogue, in place in the staging tile (which holds the relu'
    // source in kRev and kHeadBwd): acc[4 j + 2 h + e] is row rl + 8 h,
    // column 8 j + 2 (lane % 4) + e of the tile.
    mbar_wait(ready, it & 1);
    const int rl = 64 * cw + 16 * cwarp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      float b0 = 0.f, b1 = 0.f, w0 = 0.f, w1 = 0.f;
      if (MODE == kRelu || MODE == kBias) {
        b0 = to_f(p.bias[n0 + c]);
        b1 = to_f(p.bias[n0 + c + 1]);
      }
      if (MODE == kHeadBwd && p.sb) {
        w0 = p.wd[n0 + c];
        w1 = p.wd[n0 + c + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = rl + 8 * h;
        __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(out + out_off(rr, c));
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (MODE == kRelu || MODE == kBias) {
          v0 = rnd<bf16>(rnd<bf16>(v0) + b0);
          v1 = rnd<bf16>(rnd<bf16>(v1) + b1);
          if (MODE == kRelu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
        } else {
          float g0 = rnd<bf16>(v0), g1 = rnd<bf16>(v1);
          if (MODE == kHeadBwd) {
            const float sr = p.sb && m0 + rr < p.M ? p.sb[m0 + rr] : 0.f;
            g0 = rnd<bf16>(g0 + rnd<bf16>(p.sb ? sr * w0 : 0.f));
            g1 = rnd<bf16>(g1 + rnd<bf16>(p.sb ? sr * w1 : 0.f));
          }
          const float2 hv = __bfloat1622float2(*slot);
          v0 = hv.x > 0.f ? g0 : 0.f;
          v1 = hv.y > 0.f ? g1 : 0.f;
        }
        *slot = __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(done);
  }
}

struct TnMaps {
  CUtensorMap z, x0, x1;  // boxes [64 rows][64 features]
};

struct TnTma {
  int Mo, No, n0, rows, ksplit, tiles_m, tiles, units;
  float* part;   // [splits][Mo][No]
  float* bpart;  // [splits][Mo]: the column sums of Z, or null
};

// part[split][m][n] = sum over the split's rows i of z[i][m] x[i][n]: unit
// u of the grid's walk is tile u % tiles (rows 128 (tile % tiles_m) of the
// gradient, columns 256 (tile / tiles_m)) of split u / tiles. X's columns
// [0, n0) come from x0, the rest from x1 (the skip layer's [h | x]). With
// bpart the units of the first column block also write bpart[split][m] =
// the sum of z[i][m] over the split's rows, from the Z tiles of the ring:
// consumer thread c sums column c % 128 over rows 32 (c / 128) to
// 32 (c / 128) + 31 of each slice, and the two halves add in that order.
__global__ void __launch_bounds__(kWgThreads, 1)
    tn_wgmma_kernel(const __grid_constant__ TnTma p, const __grid_constant__ TnMaps m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t full = smem_u32(smem + kTnStages * kStage), empty = full + 8 * kTnStages;
  float* halves = reinterpret_cast<float*>(smem + kTnStages * kStage + 16 * kTnStages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kTnStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    reg_dealloc<kProdRegs>();
    if (tid == 0) {
      Ring r{smem_u32(smem), full, empty, kTnStages, 0, 0u};
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int tile = u % p.tiles, split = u / p.tiles;
        const int m0 = (tile % p.tiles_m) * kTM, nc = (tile / p.tiles_m) * kTN;
        const bool first = nc < p.n0;
        const CUtensorMap* xm = first ? &m.x0 : &m.x1;
        const int xc = first ? nc : nc - p.n0;
        const int i0 = split * p.ksplit;
        const int nkb = (min(p.rows, i0 + p.ksplit) - i0 + 63) / 64;
        for (int kb = 0; kb < nkb; ++kb) {
          const int i = i0 + 64 * kb;
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kStage;
          mbar_expect_tx(f, kStage);
          tma_load(dst, &m.z, f, m0, i);
          tma_load(dst + kZBox, &m.z, f, m0 + 64, i);
          for (int q = 0; q < kTN / 64; ++q) tma_load(dst + kOpA + q * kZBox, xm, f, xc + 64 * q, i);
          r.advance();
        }
      }
    }
    return;
  }

  reg_alloc<kConsRegs>();
  const int ctid = tid - 128, cw = ctid >> 7, cwarp = (ctid >> 5) & 3;
  const int bc = ctid & (kTM - 1);
  Ring r{smem_u32(smem), full, empty, kTnStages, 0, 0u};
  float acc[128];
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int tile = u % p.tiles, split = u / p.tiles;
    const int m0 = (tile % p.tiles_m) * kTM, nc = (tile / p.tiles_m) * kTN;
    const int i0 = split * p.ksplit;
    const int nkb = (min(p.rows, i0 + p.ksplit) - i0 + 63) / 64;
    const bool bias = p.bpart != nullptr && nc == 0;
    float bsum = 0.f;
    int prev = 0;
    wg_fence();
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(r.full + 8 * r.stage, r.phase);
      const uint32_t st = r.base + r.stage * kStage;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma256<1, 1>(acc, sw128_desc(st + cw * kZBox + kk * 2048, kZBox, 1024),
                       sw128_desc(st + kOpA + kk * 2048, kZBox, 1024), kb | kk);
      wg_commit();
      if (bias) {  // while the products run
        const unsigned char* zt = smem + r.stage * kStage + (bc >> 6) * kZBox;
        const int cc = bc & 63;
#pragma unroll 8
        for (int i = 0; i < 32; ++i) {
          const int row = 32 * cw + i;
          bsum += to_f(*reinterpret_cast<const bf16*>(
              zt + row * 128 + ((((cc >> 3) & 7) ^ (row & 7)) << 4) + ((cc & 7) << 1)));
        }
      }
      if (kb > 0) {
        wg_wait<1>();
        if (lane == 0) mbar_arrive(r.empty + 8 * prev);
      }
      prev = r.stage;
      r.advance();
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(r.empty + 8 * prev);
    acc_fence256(acc);

    float* out = p.part + static_cast<size_t>(split) * p.Mo * p.No;
    const int row = m0 + 64 * cw + 16 * cwarp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = nc + 8 * j + 2 * (lane & 3);
        if (col < p.No)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8 * h) * p.No + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    if (bias) {
      halves[cw * kTM + bc] = bsum;
      cons_sync();
      if (ctid < kTM)
        p.bpart[static_cast<size_t>(split) * p.Mo + m0 + ctid] = halves[ctid] + halves[kTM + ctid];
      cons_sync();
    }
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

template <int MODE>
inline int launch_nt_wgmma_mode(const NtTma& p, const NtMaps& m, int grid, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(nt_wgmma_kernel<MODE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kNtSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nt_wgmma_kernel<MODE><<<grid, kWgThreads, kNtSmem, s>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shapes the bf16 nt product takes: N a multiple of 256, the
// first K segment a multiple of 64 where a second follows (a slice never
// straddles two; past the last, TMA reads zeros), rows of a multiple of 16
// bytes at 16-byte aligned addresses (TMA); any M.
inline int launch_nt_wgmma(int mode, const NtParams& q, cudaStream_t s) {
  const bool act = mode == kRev || mode == kHeadBwd;
  if (q.M <= 0 || q.N <= 0 || q.N % kTN || q.k0 <= 0 || q.k1 < 0 || (q.k1 && q.k0 % 64) ||
      (q.k1 && (!q.a1 || q.lda1 % 8 || !aligned16(q.a1))) || !q.a0 || !q.b || !q.out ||
      q.lda0 % 8 || q.ldb % 8 || q.ldo % 8 || !aligned16(q.a0) || !aligned16(q.b) ||
      !aligned16(q.out) || (act && (!q.act || q.ld_act % 8 || !aligned16(q.act))) ||
      ((mode == kRelu || mode == kBias) && !q.bias) || (mode == kHeadBwd && q.sb && !q.wd))
    return static_cast<int>(cudaErrorInvalidValue);
  NtMaps m;
  memset(&m, 0, sizeof(m));
  bool ok = make_map(&m.a0, q.a0, q.k0, q.M, q.lda0, kTM) &&
            make_map(&m.b, q.b, q.k0 + q.k1, q.N, q.ldb, kTN) &&
            make_map(&m.out, q.out, q.N, q.M, q.ldo, kTM);
  if (q.k1) ok = ok && make_map(&m.a1, q.a1, q.k1, q.M, q.lda1, kTM);
  if (act) ok = ok && make_map(&m.act, q.act, q.N, q.M, q.ld_act, kTM);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int nk0 = (q.k0 + 63) / 64, tiles_n = q.N / kTN;
  const NtTma p{q.M, nk0, nk0 + (q.k1 + 63) / 64, tiles_n, ((q.M + kTM - 1) / kTM) * tiles_n,
                static_cast<const bf16*>(q.bias), q.sb, q.wd};
  const int grid = p.tiles < sms ? p.tiles : sms;
  switch (mode) {
    case kRelu: return launch_nt_wgmma_mode<kRelu>(p, m, grid, s);
    case kRev: return launch_nt_wgmma_mode<kRev>(p, m, grid, s);
    case kHeadBwd: return launch_nt_wgmma_mode<kHeadBwd>(p, m, grid, s);
    case kBias: return launch_nt_wgmma_mode<kBias>(p, m, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Checks the shapes the bf16 tn product takes: Mo a multiple of 128, x0's
// columns a multiple of 256 where x1 follows, splits of whole 64-row
// slices, rows of a multiple of 16 bytes at 16-byte aligned addresses; any
// No and rows.
inline int launch_tn_wgmma(int Mo, int No, int rows, int ksplit, const void* z, int ldz,
                           const void* x0, int ldx0, int n0, const void* x1, int ldx1,
                           float* part, float* bpart, cudaStream_t s) {
  if (Mo <= 0 || No <= 0 || Mo % kTM || n0 < 0 || n0 > No || (n0 < No && n0 % kTN) ||
      rows <= 0 || ksplit <= 0 || ksplit % 64 || !z || ldz % 8 || !aligned16(z) || !part ||
      (n0 && (!x0 || ldx0 % 8 || !aligned16(x0))) ||
      (n0 < No && (!x1 || ldx1 % 8 || !aligned16(x1))))
    return static_cast<int>(cudaErrorInvalidValue);
  TnMaps m;
  memset(&m, 0, sizeof(m));
  bool ok = make_map(&m.z, z, Mo, rows, ldz, 64);
  if (n0) ok = ok && make_map(&m.x0, x0, n0, rows, ldx0, 64);
  if (n0 < No) ok = ok && make_map(&m.x1, x1, No - n0, rows, ldx1, 64);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tiles_m = Mo / kTM, tiles = tiles_m * ((No + kTN - 1) / kTN);
  const int units = tiles * ((rows + ksplit - 1) / ksplit);
  const TnTma p{Mo, No, n0, rows, ksplit, tiles_m, tiles, units, part, bpart};
  const cudaError_t e = cudaFuncSetAttribute(tn_wgmma_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kTnSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tn_wgmma_kernel<<<units < sms ? units : sms, kWgThreads, kTnSmem, s>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// sig[r] = f32(y[r]) . wd, without its bias. One warp a row, each lane 8
// consecutive features of every 256.
template <typename T>
__global__ void __launch_bounds__(kThreads) sigma_kernel(int M, int W, const T* y, const float* wd,
                                                        float* sig) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* yr = y + static_cast<size_t>(row) * W;
  float s = 0.f;
  for (int k = lane * 8; k < W; k += 256) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(to_f(yr[k + e]), wd[k + e], s);
  }
  s = warp_sum(s);
  if (lane == 0) sig[row] = s;
}

// ------------------------------------- f32: three TF32 passes on wgmma

// v's TF32 high part (round to nearest, ties away) and the TF32 rounding of
// the rest (v - hi is exact in f32).
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d (+)= A B^T on one k8 step: A [64][8] tf32 from registers (a[e] is row
// 16 warp + lane / 4 + 8 (e % 2), column lane % 4 + 4 (e / 2) of the
// warpgroup's 64), B [128][8] from a 128-byte-swizzled K-major tile, f32
// accumulation (d as wgmma128's: d[4 j + 2 h + e] is row 16 warp + lane / 4
// + 8 h, column 8 j + 2 (lane % 4) + e).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= the f32 product of one k8 step in three TF32 passes, the small
// terms first: lo.hi, hi.lo, hi.hi (A's parts in registers, B's by
// descriptor).
__device__ __forceinline__ void mma3(float (&d)[64], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint64_t bh, uint64_t bl,
                                     int scale_d) {
  wgmma_tf32(d, lo, bh, scale_d);
  wgmma_tf32(d, hi, bl, 1);
  wgmma_tf32(d, hi, bh, 1);
}

// Byte offset of element (r, c < 32) of a [rows][32] f32 box, 128-byte
// swizzled as TMA writes it.
__device__ __forceinline__ uint32_t f32_off(int r, int c) {
  return static_cast<uint32_t>(r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

struct NtMapsF {
  CUtensorMap a0, a1, bh, bl;  // boxes [128][32]: A, B's two parts
};

struct NtF32 {
  int M, nk0, nk, tiles_n, tiles;  // K-slices of a0, of both; column blocks; tiles
  const float* bias;               // [N] (kRelu, kBias)
  const float* act;                // [M][ld_act]: the relu' source (kRev, kHeadBwd)
  int ld_act;
  const float* sb;                 // [M] sigma's cotangent (kHeadBwd), or null
  const float* wd;                 // [N] the density head (kHeadBwd)
  float* out;                      // [M][ldo]
  int ldo;
};

// C [M][N] = epilogue(A [M][k0 + k1] B [N][k0 + k1]^T) in f32, tile t of
// the grid's walk at rows 128 (t / tiles_n), columns 128 (t % tiles_n).
// Thread 0: the operand ring (TMA); 128-383: two consumer warpgroups of 64
// rows each. A consumer loads its A fragments of a k8 step from the
// stage's swizzled [128][32] tile (each warp's 32 lanes on 32 banks),
// splits them, and runs the three passes; the fragments of two steps
// alternate, a step's registers reused once wgmma.wait_group says the step
// two back is done. The tensor cores add into their f32 accumulators with
// truncation (round toward zero), whose bias grows with the additions: so a
// slice's 12 products go into `part`, fresh each slice, and part is added
// into `acc` in f32 (round to nearest) once the slice's products are done;
// then the stage goes back to the producer (its last B reads done). The
// epilogue (Epi, in f32) reads acc and writes straight to device memory,
// 32 bytes a row for 4 lanes.
template <int MODE>
__global__ void __launch_bounds__(kWgThreads, 1)
    nt_tf32_kernel(const __grid_constant__ NtF32 p, const __grid_constant__ NtMapsF m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t full = smem_u32(smem + kFNtStages * kFNtStage), empty = full + 8 * kFNtStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kFNtStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    reg_dealloc<kProdRegs>();
    if (tid == 0) {
      Ring r{smem_u32(smem), full, empty, kFNtStages, 0, 0u};
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int m0 = (t / p.tiles_n) * kFM, n0 = (t % p.tiles_n) * kFN;
        for (int kb = 0; kb < p.nk; ++kb) {
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kFNtStage;
          mbar_expect_tx(f, kFNtStage);
          if (kb < p.nk0)
            tma_load(dst, &m.a0, f, kb * kFK, m0);
          else
            tma_load(dst, &m.a1, f, (kb - p.nk0) * kFK, m0);
          tma_load(dst + kFA, &m.bh, f, kb * kFK, n0);
          tma_load(dst + kFA + kFB, &m.bl, f, kb * kFK, n0);
          r.advance();
        }
      }
    }
    return;
  }

  reg_alloc<kConsRegs>();
  const int ctid = tid - 128, cw = ctid >> 7, cwarp = (ctid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  Ring r{smem_u32(smem), full, empty, kFNtStages, 0, 0u};
  float acc[64], part[64];
  uint32_t h0[4], l0[4], h1[4], l1[4];
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int m0 = (t / p.tiles_n) * kFM, n0 = (t % p.tiles_n) * kFN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kb = 0; kb < p.nk; ++kb) {
      mbar_wait(r.full + 8 * r.stage, r.phase);
      const unsigned char* a = smem + r.stage * kFNtStage + cw * (kFA / 2);
      const uint32_t bh = r.base + r.stage * kFNtStage + kFA, bl = bh + kFB;
#pragma unroll
      for (int kk = 0; kk < kFK / 8; ++kk) {
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
        for (int e = 0; e < 4; ++e)
          split_tf32(*reinterpret_cast<const float*>(
                         a + f32_off(16 * cwarp + g + 8 * (e & 1), 8 * kk + q + 4 * (e >> 1))),
                     hi[e], lo[e]);
        wg_fence();
        mma3(part, hi, lo, sw128_desc(bh + 32 * kk, 16, 1024), sw128_desc(bl + 32 * kk, 16, 1024),
             kk);
        wg_commit();
      }
      prev = r.stage;
      r.advance();
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(r.empty + 8 * prev);
    acc_fence(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];

    // The epilogue: acc[4 j + 2 h + e] is row 64 cw + 16 cwarp + g + 8 h,
    // column 8 j + 2 q + e of the tile.
    const int rb = m0 + 64 * cw + 16 * cwarp + g;
#pragma unroll
    for (int j = 0; j < kFN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * q;
      float2 bv = make_float2(0.f, 0.f), wv = make_float2(0.f, 0.f);
      if (MODE == kRelu || MODE == kBias) bv = *reinterpret_cast<const float2*>(p.bias + c);
      if (MODE == kHeadBwd && p.sb) wv = *reinterpret_cast<const float2*>(p.wd + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rb + 8 * h;
        if (row >= p.M) continue;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (MODE == kRelu || MODE == kBias) {
          v0 += bv.x;
          v1 += bv.y;
          if (MODE == kRelu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
        } else {
          if (MODE == kHeadBwd && p.sb) {
            const float sr = p.sb[row];
            v0 += __fmul_rn(sr, wv.x);
            v1 += __fmul_rn(sr, wv.y);
          }
          const float2 hv = *reinterpret_cast<const float2*>(
              p.act + static_cast<size_t>(row) * p.ld_act + c);
          v0 = hv.x > 0.f ? v0 : 0.f;
          v1 = hv.y > 0.f ? v1 : 0.f;
        }
        *reinterpret_cast<float2*>(p.out + static_cast<size_t>(row) * p.ldo + c) =
            make_float2(v0, v1);
      }
    }
  }
}

struct TnMapsF {
  CUtensorMap z, x0, x1;  // boxes [32 rows][32 features]
};

// The tn product's A rows: fragment row 16 w + lane / 4 + 8 h of a 64-row
// set is feature moff(w, lane / 4, h) of it, so that a warp's loads of Z^T
// from the row-major [32][32] boxes hit 32 banks (bits 0-1 of the feature
// from lane / 4 % 4, bit 2 from h, 3 from w % 2, 4 from lane / 16, 5 from
// w / 2).
__device__ __forceinline__ int moff(int w, int g, int h) {
  return 32 * (w >> 1) + 8 * (w & 1) + (g & 3) + 4 * h + 16 * (g >> 2);
}

// part[split][m][n] = sum over the split's rows i of z[i][m] x[i][n] in f32
// (three TF32 passes): unit u of the grid's walk is tile u % tiles (rows
// 128 (tile % tiles_m) of the gradient, columns 128 (tile / tiles_m)) of
// split u / tiles. X's columns [0, n0) come from x0, the rest from x1 (the
// skip layer's [h | x]). Thread 0 keeps the ring of [32][128] Z and X
// slices (TMA) in flight; warps 1-3 transpose each X slice into K-major hi
// and lo tiles (two buffers; block b of 4 x 4 values, 8 consecutive threads
// on 32 banks both ways); the consumers load Z^T's fragments from the ring
// (split in registers), read X^T's parts by descriptor, and add each
// slice's products in f32 as nt_tf32_kernel does. With bpart the units of
// the first column block also write bpart[split][m] = the sum of z[i][m]
// over the split's rows, from the Z values the consumers load: a thread
// sums its rows in order, then the 4 lanes of a feature add as (0 + 1) +
// (2 + 3).
__global__ void __launch_bounds__(kWgThreads, 1)
    tn_tf32_kernel(const __grid_constant__ TnTma p, const __grid_constant__ TnMapsF m) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* xt = smem + kFTnStages * kFTnStage;
  const uint32_t full = smem_u32(xt + 2 * kFXt), empty = full + 8 * kFTnStages;
  const uint32_t tfull = empty + 8 * kFTnStages, tempty = tfull + 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kFTnStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kCons / 32 + 3);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(tfull + 8 * b, 3);
      mbar_init(tempty + 8 * b, kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    reg_dealloc<kProdRegs>();
    Ring r{smem_u32(smem), full, empty, kFTnStages, 0, 0u};
    int tb = 0;
    uint32_t tph = 0u;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int tile = u % p.tiles, split = u / p.tiles;
      const int m0 = (tile % p.tiles_m) * kFM, nc = (tile / p.tiles_m) * kFN;
      const int i0 = split * p.ksplit;
      const int nkb = (min(p.rows, i0 + p.ksplit) - i0 + kFK - 1) / kFK;
      if (tid == 0) {
        const bool first = nc < p.n0;
        const CUtensorMap* xm = first ? &m.x0 : &m.x1;
        const int xc = first ? nc : nc - p.n0;
        for (int kb = 0; kb < nkb; ++kb) {
          const int i = i0 + kFK * kb;
          mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1u);
          const uint32_t f = r.full + 8 * r.stage, dst = r.base + r.stage * kFTnStage;
          mbar_expect_tx(f, kFTnStage);
          for (int qz = 0; qz < kFM / 32; ++qz) tma_load(dst + qz * kFBox, &m.z, f, m0 + 32 * qz, i);
          for (int qx = 0; qx < kFN / 32; ++qx)
            tma_load(dst + kFA + qx * kFBox, xm, f, xc + 32 * qx, i);
          r.advance();
        }
      } else if (warp > 0) {
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(r.full + 8 * r.stage, r.phase);
          mbar_wait(tempty + 8 * tb, tph ^ 1u);
          const unsigned char* x = smem + r.stage * kFTnStage + kFA;
          unsigned char* xh = xt + tb * kFXt;
          for (int b = tid - 32; b < 32 * 8; b += 96) {
            // Block b: X rows 4 ib to 4 ib + 3, columns 4 nb to 4 nb + 3.
            const int grp = b >> 3, k = b & 7;
            const int nb = 8 * (grp & 3) + k, ib = (k + (grp >> 2)) & 7;
            float4 v[4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              const int i = 4 * ib + rr;
              v[rr] = *reinterpret_cast<const float4*>(x + (nb >> 3) * kFBox + i * 128 +
                                                       (((nb & 7) ^ (i & 7)) << 4));
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = 4 * nb + c;
              const float col[4] = {(&v[0].x)[c], (&v[1].x)[c], (&v[2].x)[c], (&v[3].x)[c]};
              uint4 hv, lv;
              split_tf32(col[0], hv.x, lv.x);
              split_tf32(col[1], hv.y, lv.y);
              split_tf32(col[2], hv.z, lv.z);
              split_tf32(col[3], hv.w, lv.w);
              const uint32_t o = n * 128 + ((ib ^ (n & 7)) << 4);
              *reinterpret_cast<uint4*>(xh + o) = hv;
              *reinterpret_cast<uint4*>(xh + kFB + o) = lv;
            }
          }
          fence_async_smem();
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(tfull + 8 * tb);
            mbar_arrive(r.empty + 8 * r.stage);
          }
          r.advance();
          if (++tb == 2) {
            tb = 0;
            tph ^= 1u;
          }
        }
      }
    }
    return;
  }

  reg_alloc<kConsRegs>();
  const int ctid = tid - 128, cw = ctid >> 7, cwarp = (ctid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  Ring r{smem_u32(smem), full, empty, kFTnStages, 0, 0u};
  int tb = 0;
  uint32_t tph = 0u;
  float acc[64], part[64];
  uint32_t h0[4], l0[4], h1[4], l1[4];
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int tile = u % p.tiles, split = u / p.tiles;
    const int m0 = (tile % p.tiles_m) * kFM, nc = (tile / p.tiles_m) * kFN;
    const int i0 = split * p.ksplit;
    const int nkb = (min(p.rows, i0 + p.ksplit) - i0 + kFK - 1) / kFK;
    const bool bias = p.bpart != nullptr && nc == 0;
    float bsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(r.full + 8 * r.stage, r.phase);
      mbar_wait(tfull + 8 * tb, tph);
      const unsigned char* z = smem + r.stage * kFTnStage;
      const uint32_t xh = smem_u32(xt) + tb * kFXt, xl = xh + kFB;
#pragma unroll
      for (int kk = 0; kk < kFK / 8; ++kk) {
        uint32_t(&hi)[4] = (kk & 1) ? h1 : h0;
        uint32_t(&lo)[4] = (kk & 1) ? l1 : l0;
        if (kk == 0) {  // the previous slice's products are done: add them
          wg_wait<0>();
          if (kb > 0) {
            if (lane == 0) mbar_arrive(tempty + 8 * prev);
            acc_fence(part);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] += part[i];
          }
        } else {
          wg_wait<1>();
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mm = 64 * cw + moff(cwarp, g, e & 1);
          const float v = *reinterpret_cast<const float*>(
              z + (mm >> 5) * kFBox + f32_off(8 * kk + q + 4 * (e >> 1), mm & 31));
          if (bias) bsum[e & 1] += v;
          split_tf32(v, hi[e], lo[e]);
        }
        wg_fence();
        mma3(part, hi, lo, sw128_desc(xh + 32 * kk, 16, 1024), sw128_desc(xl + 32 * kk, 16, 1024),
             kk);
        wg_commit();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(r.empty + 8 * r.stage);  // Z's values are in registers
      prev = tb;
      r.advance();
      if (++tb == 2) {
        tb = 0;
        tph ^= 1u;
      }
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(tempty + 8 * prev);
    acc_fence(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];

    // acc[4 j + 2 h + e] is gradient row 64 cw + moff(cwarp, g, h), column
    // 8 j + 2 q + e of the tile.
    float* out = p.part + static_cast<size_t>(split) * p.Mo * p.No;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = m0 + 64 * cw + moff(cwarp, g, h);
#pragma unroll
      for (int j = 0; j < kFN / 8; ++j) {
        const int col = nc + 8 * j + 2 * q;
        if (col < p.No)
          *reinterpret_cast<float2*>(out + row * p.No + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      if (bias) {
        float v = bsum[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) p.bpart[static_cast<size_t>(split) * p.Mo + row] = v;
      }
    }
  }
}

// A tensor map of a row-major f32 matrix [rows][cols] (row stride `ld`
// elements) in boxes of box_rows x 32 columns, 128-byte swizzled; reads
// past the matrix give zeros. Returns false on failure.
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

inline bool aligned8(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 7) == 0; }

template <int MODE>
inline int launch_nt_tf32_mode(const NtF32& p, const NtMapsF& m, int grid, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(nt_tf32_kernel<MODE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kF32NtSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  nt_tf32_kernel<MODE><<<grid, kWgThreads, kF32NtSmem, s>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shapes the f32 nt product takes: N a multiple of 128, the
// first K segment a multiple of 32 where a second follows, B's low part
// given; TMA's rows of a multiple of 16 bytes at 16-byte aligned addresses,
// the epilogue's float2 rows at 8-byte aligned ones; any M.
inline int launch_nt_tf32(int mode, const NtParams& q, cudaStream_t s) {
  const bool act = mode == kRev || mode == kHeadBwd;
  if (q.M <= 0 || q.N <= 0 || q.N % kFN || q.k0 <= 0 || q.k1 < 0 || (q.k1 && q.k0 % kFK) ||
      (q.k1 && (!q.a1 || q.lda1 % 4 || !aligned16(q.a1))) || !q.a0 || !q.b || !q.b_lo ||
      !q.out || q.lda0 % 4 || q.ldb % 4 || q.ldo % 2 || !aligned16(q.a0) || !aligned16(q.b) ||
      !aligned16(q.b_lo) || !aligned8(q.out) ||
      (act && (!q.act || q.ld_act % 2 || !aligned8(q.act))) ||
      ((mode == kRelu || mode == kBias) && (!q.bias || !aligned8(q.bias))) ||
      (mode == kHeadBwd && q.sb && (!q.wd || !aligned8(q.wd))))
    return static_cast<int>(cudaErrorInvalidValue);
  NtMapsF m;
  memset(&m, 0, sizeof(m));
  bool ok = make_map_f32(&m.a0, q.a0, q.k0, q.M, q.lda0, kFM) &&
            make_map_f32(&m.bh, q.b, q.k0 + q.k1, q.N, q.ldb, kFN) &&
            make_map_f32(&m.bl, q.b_lo, q.k0 + q.k1, q.N, q.ldb, kFN);
  if (q.k1) ok = ok && make_map_f32(&m.a1, q.a1, q.k1, q.M, q.lda1, kFM);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int nk0 = (q.k0 + kFK - 1) / kFK, tiles_n = q.N / kFN;
  const NtF32 p{q.M,
                nk0,
                nk0 + (q.k1 + kFK - 1) / kFK,
                tiles_n,
                ((q.M + kFM - 1) / kFM) * tiles_n,
                static_cast<const float*>(q.bias),
                static_cast<const float*>(q.act),
                q.ld_act,
                q.sb,
                q.wd,
                static_cast<float*>(q.out),
                q.ldo};
  const int grid = p.tiles < sms ? p.tiles : sms;
  switch (mode) {
    case kRelu: return launch_nt_tf32_mode<kRelu>(p, m, grid, s);
    case kRev: return launch_nt_tf32_mode<kRev>(p, m, grid, s);
    case kHeadBwd: return launch_nt_tf32_mode<kHeadBwd>(p, m, grid, s);
    case kBias: return launch_nt_tf32_mode<kBias>(p, m, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Checks the shapes the f32 tn product takes: Mo a multiple of 128, x0's
// columns a multiple of 128 where x1 follows, No even, splits of whole
// 32-row slices, TMA's rows of a multiple of 16 bytes at 16-byte aligned
// addresses; any rows.
inline int launch_tn_tf32(int Mo, int No, int rows, int ksplit, const void* z, int ldz,
                          const void* x0, int ldx0, int n0, const void* x1, int ldx1, float* part,
                          float* bpart, cudaStream_t s) {
  if (Mo <= 0 || No <= 0 || Mo % kFM || No % 2 || n0 < 0 || n0 > No || (n0 < No && n0 % kFN) ||
      rows <= 0 || ksplit <= 0 || ksplit % kFK || !z || ldz % 4 || !aligned16(z) || !part ||
      !aligned8(part) || (n0 && (!x0 || ldx0 % 4 || !aligned16(x0))) ||
      (n0 < No && (!x1 || ldx1 % 4 || !aligned16(x1))))
    return static_cast<int>(cudaErrorInvalidValue);
  TnMapsF m;
  memset(&m, 0, sizeof(m));
  bool ok = make_map_f32(&m.z, z, Mo, rows, ldz, kFK);
  if (n0) ok = ok && make_map_f32(&m.x0, x0, n0, rows, ldx0, kFK);
  if (n0 < No) ok = ok && make_map_f32(&m.x1, x1, No - n0, rows, ldx1, kFK);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tiles_m = Mo / kFM, tiles = tiles_m * ((No + kFN - 1) / kFN);
  const int units = tiles * ((rows + ksplit - 1) / ksplit);
  const TnTma p{Mo, No, n0, rows, ksplit, tiles_m, tiles, units, part, bpart};
  const cudaError_t e = cudaFuncSetAttribute(tn_tf32_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kF32TnSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tn_tf32_kernel<<<units < sms ? units : sms, kWgThreads, kF32TnSmem, s>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// hi[i], lo[i] = the TF32 parts of v[i] (the f32 products' B operands).
__global__ void __launch_bounds__(kThreads) split_kernel(int n, const float* v, float* hi,
                                                        float* lo) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    uint32_t h, l;
    split_tf32(v[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// part[blk][c] = sum over the block's rows r of v[r][c], scaled by s[r]
// where s is given: the density head's gradient (s = sigma's cotangent, v =
// y).
template <typename T>
__global__ void __launch_bounds__(kThreads) colsum_kernel(int rows, int cols, const T* v, int ldv,
                                                         const float* s, int block_rows,
                                                         float* part) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * block_rows, r1 = min(rows, r0 + block_rows);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float x = to_f(v[static_cast<size_t>(r) * ldv + c]);
    acc = s ? fmaf(s[r], x, acc) : acc + x;
  }
  part[static_cast<size_t>(blockIdx.y) * cols + c] = acc;
}

// Plain C entries for ctypes: each returns the cudaError_t of its launch (0
// on success; an argument or a tensor map it refuses gives
// cudaErrorInvalidValue), allocates nothing and does not synchronise; all
// run on `stream`. (C linkage inside the namespace: the names are the C
// ones, and lookup stays within w1024.)

// One layer or head product, forward or backward (Epi `mode`), in bf16
// (bf = 1; b_lo null) or f32 (b and b_lo the TF32 parts of B from
// refnerf_w1024_split).
extern "C" int refnerf_w1024_nt(int bf, int mode, int M, int N, const void* a0, int lda0, int k0,
                                const void* a1, int lda1, int k1, const void* b,
                                const void* b_lo, int ldb, const void* bias, const void* act,
                                int ld_act, const float* sb, const float* wd, void* out, int ldo,
                                void* stream) {
  const NtParams p{M,    N,    a0,  lda0, k0,     a1, lda1, k1, b,
                   b_lo, ldb, bias, act,  ld_act, sb, wd,   out, ldo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf) return b_lo ? static_cast<int>(cudaErrorInvalidValue) : launch_nt_wgmma(mode, p, s);
  return launch_nt_tf32(mode, p, s);
}

// hi, lo [n] = the TF32 parts of v [n] (f32): the B operands of the f32
// products, split once a call.
extern "C" int refnerf_w1024_split(int n, const float* v, float* hi, float* lo, void* stream) {
  if (n <= 0 || !v || !hi || !lo) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  split_kernel<<<blocks < 4096 ? blocks : 4096, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, v, hi, lo);
  return static_cast<int>(cudaGetLastError());
}

// sigma (without its bias) of y [M][W].
extern "C" int refnerf_w1024_sigma(int bf, int M, int W, const void* y, const float* wd,
                                   float* sig, void* stream) {
  if (M <= 0 || W <= 0 || W % 256 || !y || !wd || !sig)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kThreads / 32;
  const dim3 grid((M + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf)
    sigma_kernel<bf16><<<grid, kThreads, 0, s>>>(M, W, static_cast<const bf16*>(y), wd, sig);
  else
    sigma_kernel<float><<<grid, kThreads, 0, s>>>(M, W, static_cast<const float*>(y), wd, sig);
  return static_cast<int>(cudaGetLastError());
}

// The weight gradient's partials over `rows` rows in splits of `ksplit`,
// and, where `bpart` is given, the bias gradient's (the column sums of z)
// per split; bf16 (bf = 1) or f32 (three TF32 passes).
extern "C" int refnerf_w1024_tn(int bf, int Mo, int No, int rows, int ksplit, const void* z,
                                int ldz, const void* x0, int ldx0, int n0, const void* x1,
                                int ldx1, float* part, float* bpart, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf)
    return launch_tn_wgmma(Mo, No, rows, ksplit, z, ldz, x0, ldx0, n0, x1, ldx1, part, bpart, s);
  return launch_tn_tf32(Mo, No, rows, ksplit, z, ldz, x0, ldx0, n0, x1, ldx1, part, bpart, s);
}

// Column sums of v [rows][cols] (bf16 when vbf, else f32), each row scaled
// by s[r] where s is given, per block of block_rows rows: part[blocks][cols].
extern "C" int refnerf_w1024_colsum(int vbf, int rows, int cols, const void* v, int ldv,
                                    const float* s, int block_rows, float* part, void* stream) {
  if (rows <= 0 || cols <= 0 || !v || !part || block_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + kThreads - 1) / kThreads, (rows + block_rows - 1) / block_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vbf)
    colsum_kernel<bf16><<<grid, kThreads, 0, st>>>(rows, cols, static_cast<const bf16*>(v), ldv, s,
                                                   block_rows, part);
  else
    colsum_kernel<float><<<grid, kThreads, 0, st>>>(rows, cols, static_cast<const float*>(v), ldv,
                                                    s, block_rows, part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace w1024

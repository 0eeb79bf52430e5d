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
// f32 (nt_f32_kernel, tn_f32_kernel): full f32 on the FMA pipes (no TF32),
// 128 x 128 tiles of 256 threads, 8 x 8 outputs a thread, 16-deep slices
// double-buffered.
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
// 524,288 rows: 9.16 ms in bf16 on the tensor cores, 135 ms in f32 on the
// FMA pipes); sigma reads y once.
//
// The backward, per slab of rows: the activations recomputed with the
// forward's nt products (the kernels keep their inputs, not their
// activations), the heads' backward (kHeadBwd: zeta of the last layer from
// the bottleneck's and sigma's cotangents), and layer by layer downwards
// the weight gradient dW_l = zeta_l^T [h_{l-1} | x] (the tn product, split
// over rows into partials; in bf16 with the bias gradient's partials), in
// f32 the bias gradient (column sums), and zeta_{l-1} (kRev). Every sum
// over rows is a fixed-order sum of per-CTA partials (trunk_bwd.cu's
// `refnerf_reduce`, no atomics), so a gradient does not depend on the
// schedule and a resumed run stays bit for bit. Bounded by the products'
// operations: 25.8 TFLOP at 524,288 rows (recomputation not counted), 26.1
// ms in bf16, 385 ms in f32.
//
// The wrappers (ops/fused_mlp.py `_w1024_forward`, `_w1024_backward`)
// allocate every buffer and sequence the launches on PyTorch's current
// stream.

#include <string.h>

#include "hopper_tma.cuh"

namespace w1024 {

using bf16 = __nv_bfloat16;

// f32: 128 x 128 output tiles, 256 threads (thread (ty, tx) of 16 x 16).
constexpr int kBM = 128;       // output rows a CTA
constexpr int kBN = 128;       // output columns a CTA
constexpr int kThreads = 256;
constexpr int kBK = 32;        // the K segments' granule (f32)
// f32: 16-deep slices, two buffers, [k][row] tiles padded by 16 bytes.
constexpr int kFK = 16;
constexpr int kFLd = kBM + 4;

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
constexpr int kSmemF32 = 2 * 2 * kFK * kFLd * 4;                // 33,792 B

enum Epi { kRelu = 0, kRev = 1, kHeadBwd = 2, kBias = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Round to the compute dtype and back.
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

template <typename T> __device__ __forceinline__ void store2(T* dst, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// A 16-byte copy into shared memory; zeros where `valid` is false (rows past
// the end: they add nothing to a sum over rows).
__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
  int ldb;
  const void* bias;  // [N] cdt (kRelu, kBias)
  const void* act;   // [M][ld_act] cdt: relu' source (kRev, kHeadBwd)
  int ld_act;
  const float* sb;   // [M] sigma's cotangent (kHeadBwd), or null
  const float* wd;   // [N] the density head (kHeadBwd)
  void* out;         // [M][ldo] cdt
  int ldo;
};

template <typename T, int MODE>
__device__ __forceinline__ float epilogue(const NtParams& p, int row, int col, float acc) {
  if (MODE == kRelu || MODE == kBias) {
    const float v = rnd<T>(rnd<T>(acc) + to_f(static_cast<const T*>(p.bias)[col]));
    return MODE == kRelu ? fmaxf(v, 0.f) : v;
  }
  float g = rnd<T>(acc);
  if (MODE == kHeadBwd) g = rnd<T>(g + rnd<T>(p.sb ? p.sb[row] * p.wd[col] : 0.f));
  const T h = static_cast<const T*>(p.act)[static_cast<size_t>(row) * p.ld_act + col];
  return to_f(h) > 0.f ? g : 0.f;
}

// The f32 nt product: A and B K-contiguous in device memory, transposed into
// [k][row] tiles through registers (the next slice loads while this one
// multiplies). Thread (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2) nt_f32_kernel(NtParams p) {
  __shared__ __align__(16) float sA[2][kFK][kFLd];
  __shared__ __align__(16) float sB[2][kFK][kFLd];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = (p.k0 + p.k1) / kFK;
  const float* B = static_cast<const float*>(p.b);
  float4 ra[2], rb[2];

  auto fetch = [&](int kt) {
    const int kk = kt * kFK;
    const bool first = kk < p.k0;
    const float* a = static_cast<const float*>(first ? p.a0 : p.a1);
    const int lda = first ? p.lda0 : p.lda1, ka = first ? kk : kk - p.k0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 4;
      const int row = m0 + r;
      ra[i] = row < p.M ? *reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * lda + ka + kc)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      rb[i] = *reinterpret_cast<const float4*>(B + static_cast<size_t>(n0 + r) * p.ldb + kk + kc);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, kc = (c & 3) * 4;
      sA[buf][kc + 0][r] = ra[i].x;
      sA[buf][kc + 1][r] = ra[i].y;
      sA[buf][kc + 2][r] = ra[i].z;
      sA[buf][kc + 3][r] = ra[i].w;
      sB[buf][kc + 0][r] = rb[i].x;
      sB[buf][kc + 1][r] = rb[i].y;
      sB[buf][kc + 2][r] = rb[i].z;
      sB[buf][kc + 3][r] = rb[i].w;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (ktiles > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sA[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) stash(buf ^ 1);
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= p.M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const float v0 = epilogue<float, MODE>(p, row, col + j, acc[i][half * 4 + j]);
        const float v1 = epilogue<float, MODE>(p, row, col + j + 1, acc[i][half * 4 + j + 1]);
        store2<float>(out + static_cast<size_t>(row) * p.ldo + col + j, v0, v1);
      }
    }
  }
}

template <int MODE>
inline int launch_nt_mode(const NtParams& p, cudaStream_t s) {
  const dim3 grid((p.M + kBM - 1) / kBM, p.N / kBN);
  nt_f32_kernel<MODE><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shapes the f32 products take: N a multiple of 128, each K
// segment of 32 (a slice never straddles two), 16-byte aligned rows.
inline int launch_nt(int mode, const NtParams& p, cudaStream_t s) {
  const int vec = 4;
  if (p.M <= 0 || p.N <= 0 || p.N % kBN || p.k0 < 0 || p.k1 < 0 || p.k0 % kBK || p.k1 % kBK ||
      p.k0 + p.k1 <= 0 || (p.k1 && !p.a1) || !p.a0 || !p.b || !p.out || p.lda0 % vec ||
      (p.k1 && p.lda1 % vec) || p.ldb % vec || p.ldo % 2 ||
      ((mode == kRelu || mode == kBias) && !p.bias) ||
      ((mode == kRev || mode == kHeadBwd) && !p.act) ||
      (mode == kHeadBwd && p.sb && !p.wd))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kRelu: return launch_nt_mode<kRelu>(p, s);
    case kRev: return launch_nt_mode<kRev>(p, s);
    case kHeadBwd: return launch_nt_mode<kHeadBwd>(p, s);
    case kBias: return launch_nt_mode<kBias>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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

// part[split][m][n] = sum over this split's rows i of z[i][m] x[i][n]: the
// weight gradient's partials. X's columns [0, n0) come from x0, the rest
// from x1 (the skip layer's [h | x]).
struct TnParams {
  int Mo, No, rows, ksplit;
  const void* z;
  int ldz;
  const void* x0;
  int ldx0, n0;
  const void* x1;
  int ldx1;
  float* part;
};

// The f32 tn product: both operands row-major in device memory, copied as
// they lie into [row][feature] tiles (cp.async, two buffers); the thread
// layout of nt_f32_kernel.
__global__ void __launch_bounds__(kThreads, 2) tn_f32_kernel(TnParams p) {
  __shared__ __align__(16) float sZ[2][kFK][kFLd];
  __shared__ __align__(16) float sX[2][kFK][kFLd];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int i0 = blockIdx.z * p.ksplit;
  const int i1 = min(p.rows, i0 + p.ksplit);
  const int ktiles = i1 > i0 ? (i1 - i0 + kFK - 1) / kFK : 0;
  const bool first = n0 < p.n0;
  const float* X = first ? static_cast<const float*>(p.x0) + n0
                         : static_cast<const float*>(p.x1) + (n0 - p.n0);
  const int ldx = first ? p.ldx0 : p.ldx1;
  const float* Z = static_cast<const float*>(p.z) + m0;

  auto load = [&](int buf, int kt) {
    const int i = i0 + kt * kFK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * kThreads, r = c >> 5, ch = (c & 31) * 4;
      const int row = i + r;
      const bool ok = row < i1;
      const size_t at = static_cast<size_t>(ok ? row : 0);
      cp16(&sZ[buf][r][ch], Z + at * p.ldz + ch, ok);
      cp16(&sX[buf][r][ch], X + at * ldx + ch, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (ktiles > 0) load(0, 0);
  cp_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) load(buf ^ 1, kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sZ[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sZ[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sX[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sX[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_wait<0>();

  float* out = p.part + static_cast<size_t>(blockIdx.z) * p.Mo * p.No;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      float* o = out + static_cast<size_t>(row) * p.No + col;
      store2<float>(o, acc[i][half * 4], acc[i][half * 4 + 1]);
      store2<float>(o + 2, acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
    }
  }
}

// part[blk][c] = sum over the block's rows r of v[r][c], scaled by s[r]
// where s is given: a bias gradient, or the density head's (s = sigma's
// cotangent, v = y).
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
// (bf = 1) or f32.
extern "C" int refnerf_w1024_nt(int bf, int mode, int M, int N, const void* a0, int lda0, int k0,
                                const void* a1, int lda1, int k1, const void* b, int ldb,
                                const void* bias, const void* act, int ld_act, const float* sb,
                                const float* wd, void* out, int ldo, void* stream) {
  const NtParams p{M, N, a0, lda0, k0, a1, lda1, k1, b, ldb, bias, act, ld_act, sb, wd, out, ldo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf ? launch_nt_wgmma(mode, p, s) : launch_nt(mode, p, s);
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
// and in bf16, where `bpart` is given, the bias gradient's (the column sums
// of z) per split. f32 leaves bpart null: its bias gradients are column
// sums (refnerf_w1024_colsum).
extern "C" int refnerf_w1024_tn(int bf, int Mo, int No, int rows, int ksplit, const void* z,
                                int ldz, const void* x0, int ldx0, int n0, const void* x1,
                                int ldx1, float* part, float* bpart, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf)
    return launch_tn_wgmma(Mo, No, rows, ksplit, z, ldz, x0, ldx0, n0, x1, ldx1, part, bpart, s);
  const int vec = 4;
  if (Mo <= 0 || No <= 0 || Mo % kBM || No % kBN || n0 < 0 || n0 > No || n0 % kBN || rows <= 0 ||
      ksplit <= 0 || ksplit % kBK || !z || !part || bpart || ldz % vec ||
      (n0 && (!x0 || ldx0 % vec)) || (n0 < No && (!x1 || ldx1 % vec)))
    return static_cast<int>(cudaErrorInvalidValue);
  const TnParams p{Mo, No, rows, ksplit, z, ldz, x0, ldx0, n0, x1, ldx1, part};
  const dim3 grid(No / kBN, Mo / kBM, (rows + ksplit - 1) / ksplit);
  tn_f32_kernel<<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
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

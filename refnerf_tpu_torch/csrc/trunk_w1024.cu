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
// weight gradients' C = Z^T X over rows, "tn": both operands row-major):
// 128 x 128 output tiles, 256 threads (8 warps, 2 along rows x 4 along
// columns). bf16: mma.sync m16n8k16 with f32 accumulation, operands
// streamed through a 4-stage cp.async ring of 32-deep slices and read with
// ldmatrix (.trans for the tn product's row-major operands). f32: full f32
// on the FMA pipes (no TF32), 8 x 8 outputs a thread, 16-deep slices
// double-buffered. An operand may come in two K segments (the skip layer's
// [activation | input], the weight gradient's [h | x]): never concatenated.
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
// over rows into partials), the bias gradient (column sums) and zeta_{l-1}
// (kRev). Every sum over rows is a fixed-order sum of per-CTA partials
// (trunk_bwd.cu's `refnerf_reduce`, no atomics), so a gradient does not
// depend on the schedule and a resumed run stays bit for bit. Bounded by
// the products' operations: 25.8 TFLOP at 524,288 rows (recomputation not
// counted), 26.1 ms in bf16, 385 ms in f32.
//
// The wrappers (ops/fused_mlp.py `_w1024_forward`, `_w1024_backward`)
// allocate every buffer and sequence the launches on PyTorch's current
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w1024 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // output rows a CTA
constexpr int kBN = 128;       // output columns a CTA
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
// bf16: 32-deep slices in a 4-stage ring, rows padded by 16 bytes (ldmatrix
// without bank conflicts).
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kLdK = kBK + 8;  // [row][k] tiles of the nt product
constexpr int kLdM = kBM + 8;  // [k][row] tiles of the tn product
// f32: 16-deep slices, two buffers, [k][row] tiles padded by 16 bytes.
constexpr int kFK = 16;
constexpr int kFLd = kBM + 4;

// Dynamic shared memory of each product (fused_mlp.kernel_smem mirrors it).
constexpr int kNtSmemBf16 = kStages * (kBM + kBN) * kLdK * 2;   // 81,920 B
constexpr int kTnSmemBf16 = kStages * 2 * kBK * kLdM * 2;       // 69,632 B
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
template <> __device__ __forceinline__ void store2<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
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

__device__ __forceinline__ void ldm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2) nt_bf16_kernel(NtParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);   // [kStages][kBM][kLdK]
  bf16* sB = sA + kStages * kBM * kLdK;       // [kStages][kBN][kLdK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = (p.k0 + p.k1) / kBK;
  const bf16* B = static_cast<const bf16*>(p.b);

  auto load = [&](int stage, int kt) {
    const int kk = kt * kBK;
    const bool first = kk < p.k0;
    const bf16* a = static_cast<const bf16*>(first ? p.a0 : p.a1);
    const int lda = first ? p.lda0 : p.lda1, ka = first ? kk : kk - p.k0;
    bf16* dA = sA + stage * kBM * kLdK;
    bf16* dB = sB + stage * kBN * kLdK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, ch = (c & 3) * 8;
      const int row = m0 + r;
      const bool ok = row < p.M;
      cp16(dA + r * kLdK + ch, a + static_cast<size_t>(ok ? row : 0) * lda + ka + ch, ok);
      cp16(dB + r * kLdK + ch, B + static_cast<size_t>(n0 + r) * p.ldb + kk + ch, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < ktiles) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_commit();
    const bf16* tA = sA + (kt % kStages) * kBM * kLdK;
    const bf16* tB = sB + (kt % kStages) * kBN * kLdK;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldm_x4(af[mt], tA + (wm * 64 + mt * 16 + (lane & 15)) * kLdK + ks + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        const int j = lane >> 3;
        ldm_x4(r, tB + (wn * 32 + np * 16 + (lane & 7) + (j >> 1) * 8) * kLdK + ks + (j & 1) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (row >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        const float v0 = epilogue<bf16, MODE>(p, row, col, acc[mt][nt][2 * h]);
        const float v1 = epilogue<bf16, MODE>(p, row, col + 1, acc[mt][nt][2 * h + 1]);
        store2<bf16>(out + static_cast<size_t>(row) * p.ldo + col, v0, v1);
      }
    }
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
inline int launch_nt_mode(int bf, const NtParams& p, cudaStream_t s) {
  const dim3 grid((p.M + kBM - 1) / kBM, p.N / kBN);
  if (bf) {
    const cudaError_t e = cudaFuncSetAttribute(
        nt_bf16_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kNtSmemBf16);
    if (e != cudaSuccess) return static_cast<int>(e);
    nt_bf16_kernel<MODE><<<grid, kThreads, kNtSmemBf16, s>>>(p);
  } else {
    nt_f32_kernel<MODE><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Checks the shapes the products take: N a multiple of 128, each K segment
// of 32 (a slice never straddles two), 16-byte aligned rows.
inline int launch_nt(int bf, int mode, const NtParams& p, cudaStream_t s) {
  const int vec = bf ? 8 : 4;
  if (p.M <= 0 || p.N <= 0 || p.N % kBN || p.k0 < 0 || p.k1 < 0 || p.k0 % kBK || p.k1 % kBK ||
      p.k0 + p.k1 <= 0 || (p.k1 && !p.a1) || !p.a0 || !p.b || !p.out || p.lda0 % vec ||
      (p.k1 && p.lda1 % vec) || p.ldb % vec || p.ldo % 2 ||
      ((mode == kRelu || mode == kBias) && !p.bias) ||
      ((mode == kRev || mode == kHeadBwd) && !p.act) ||
      (mode == kHeadBwd && p.sb && !p.wd))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kRelu: return launch_nt_mode<kRelu>(bf, p, s);
    case kRev: return launch_nt_mode<kRev>(bf, p, s);
    case kHeadBwd: return launch_nt_mode<kHeadBwd>(bf, p, s);
    case kBias: return launch_nt_mode<kBias>(bf, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

__global__ void __launch_bounds__(kThreads, 2) tn_bf16_kernel(TnParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sZ = reinterpret_cast<bf16*>(smem);   // [kStages][kBK][kLdM]
  bf16* sX = sZ + kStages * kBK * kLdM;       // [kStages][kBK][kLdM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int i0 = blockIdx.z * p.ksplit;
  const int i1 = min(p.rows, i0 + p.ksplit);
  const int ktiles = i1 > i0 ? (i1 - i0 + kBK - 1) / kBK : 0;
  const bool first = n0 < p.n0;
  const bf16* X = first ? static_cast<const bf16*>(p.x0) + n0
                        : static_cast<const bf16*>(p.x1) + (n0 - p.n0);
  const int ldx = first ? p.ldx0 : p.ldx1;
  const bf16* Z = static_cast<const bf16*>(p.z) + m0;

  auto load = [&](int stage, int kt) {
    const int i = i0 + kt * kBK;
    bf16* dZ = sZ + stage * kBK * kLdM;
    bf16* dX = sX + stage * kBK * kLdM;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * kThreads, r = c >> 4, ch = (c & 15) * 8;
      const int row = i + r;
      const bool ok = row < i1;
      const size_t at = static_cast<size_t>(ok ? row : 0);
      cp16(dZ + r * kLdM + ch, Z + at * p.ldz + ch, ok);
      cp16(dX + r * kLdM + ch, X + at * ldx + ch, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < ktiles) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_commit();
    const bf16* tZ = sZ + (kt % kStages) * kBK * kLdM;
    const bf16* tX = sX + (kt % kStages) * kBK * kLdM;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldm_x4_t(af[mt], tZ + (ks + (lane & 7) + (lane >> 4) * 8) * kLdM + wm * 64 + mt * 16 +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldm_x4_t(r, tX + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdM + wn * 32 + np * 16 +
                        (lane >> 4) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  float* out = p.part + static_cast<size_t>(blockIdx.z) * p.Mo * p.No;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        store2<float>(out + static_cast<size_t>(row) * p.No + col, acc[mt][nt][2 * h],
                      acc[mt][nt][2 * h + 1]);
      }
    }
}

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

}  // namespace w1024

using namespace w1024;

// One layer or head product, forward or backward (Epi `mode`), in bf16
// (bf = 1) or f32.
extern "C" int refnerf_w1024_nt(int bf, int mode, int M, int N, const void* a0, int lda0, int k0,
                                const void* a1, int lda1, int k1, const void* b, int ldb,
                                const void* bias, const void* act, int ld_act, const float* sb,
                                const float* wd, void* out, int ldo, void* stream) {
  const NtParams p{M, N, a0, lda0, k0, a1, lda1, k1, b, ldb, bias, act, ld_act, sb, wd, out, ldo};
  return launch_nt(bf, mode, p, static_cast<cudaStream_t>(stream));
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

// The weight gradient's partials over `rows` rows in splits of `ksplit`.
extern "C" int refnerf_w1024_tn(int bf, int Mo, int No, int rows, int ksplit, const void* z,
                                int ldz, const void* x0, int ldx0, int n0, const void* x1,
                                int ldx1, float* part, void* stream) {
  const int vec = bf ? 8 : 4;
  if (Mo <= 0 || No <= 0 || Mo % kBM || No % kBN || n0 < 0 || n0 > No || n0 % kBN || rows <= 0 ||
      ksplit <= 0 || ksplit % kBK || !z || !part || ldz % vec || (n0 && (!x0 || ldx0 % vec)) ||
      (n0 < No && (!x1 || ldx1 % vec)))
    return static_cast<int>(cudaErrorInvalidValue);
  const TnParams p{Mo, No, rows, ksplit, z, ldz, x0, ldx0, n0, x1, ldx1, part};
  const dim3 grid(No / kBN, Mo / kBM, (rows + ksplit - 1) / ksplit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf) {
    const cudaError_t e = cudaFuncSetAttribute(
        tn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTnSmemBf16);
    if (e != cudaSuccess) return static_cast<int>(e);
    tn_bf16_kernel<<<grid, kThreads, kTnSmemBf16, s>>>(p);
  } else {
    tn_f32_kernel<<<grid, kThreads, 0, s>>>(p);
  }
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

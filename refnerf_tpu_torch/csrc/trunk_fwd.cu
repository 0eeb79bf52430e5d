// Layer-fused dense trunk forward for Hopper (sm_90a).
//
// Replaces the forward Pallas kernel `_fwd_kernel` of
// refnerf_tpu/ops/pallas/fused_mlp.py in its two serving modes:
//   K1  spatial trunk (`fused_encoded_trunk`): segments (xs, xc), density
//       head, f32 head block, compute-dtype bottleneck head;
//   K2  directional trunk (`fused_trunk`): segments (bottleneck, IDE + n.v),
//       f32 rgb head.
//
// What it computes (fused_mlp.py `_forward_trunk`, `_fwd_kernel`):
//   h_0 = relu(cdt(x @ W0) + cdt(b0)),  x = [seg0 | seg1] read in place
//   h_l = relu(cdt(h_{l-1} @ Wa_l [+ x @ Wb_l at the skip layer]) + cdt(b_l))
//   sigma = f32(y) . wd                      (bias added by the caller)
//   hf    = f32(y) @ wh + bh                 (f32 heads)
//   hc    = cdt(y @ wc) + cdt(bc)            (compute-dtype head)
// with every product accumulated in f32. In bf16 mode the f32 sum is rounded
// to bf16 before the bf16 bias add, then ReLU, as the Pallas kernel does.
// f32 mode runs on the FMA pipes (no TF32), so it matches a full-f32 matmul.
//
// Design. A CTA owns kRows samples. Their activation tile and the two input
// segments stay in shared memory across all layers and the heads; no
// intermediate activation touches device memory. The layer weights (1 MB in
// bf16 for the spatial trunk, more than a CTA's 227 KB) stream through a
// double-buffered K-slice ring with cp.async. Weights arrive pre-laid-out
// by the wrapper as one [out][K] matrix per layer (K contiguous, zero-padded
// to a multiple of kKS), which is exactly the mma B-fragment order.
//
// Bound on the H100: at N = 524,288 samples a flagship trunk is ~0.57 TFLOP,
// and the only device-memory traffic is the segments in and the heads out
// (~0.2-0.26 GB; the weights stay in L2), about 2,000 FLOP per byte, so the
// kernel is bound by the tensor-core (bf16) or FMA (f32) issue rate. This first version uses mma.sync m16n8k16 (bf16) and plain FMA
// (f32); wgmma/TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // samples per CTA
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kKS = 32;        // K-slice of a layer's weights per pipeline stage

// Row padding (elements) of every shared-memory matrix: 16 bytes, which
// makes the fragment loads below free of bank conflicts.
template <typename T> struct Pad { static constexpr int v = 16 / sizeof(T); };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to the compute dtype and back.
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// z = cdt(acc) + cdt(bias), rounded to cdt (fused_mlp.py:583, :649).
template <typename T> __device__ __forceinline__ float bias_add(float acc, T bias) {
  return round_t<T>(round_t<T>(acc) + to_f(bias));
}

template <typename T> __device__ __forceinline__ void store2(T* dst, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Each thread owns the outputs of the m16n8k16 accumulator layout:
// acc[mt][nt][i] sits at row wm*32 + mt*16 + g + 8*(i >= 2) and column
// wn*(NOUT/4) + nt*8 + 2*t + (i & 1), with g = lane / 4 and t = lane % 4.
// The f32 path keeps the same ownership so the epilogues are shared.

// One K-slice on the tensor cores: A [rows][lda] bf16 from column ac,
// B [NOUT][kKS + pad] bf16 (k contiguous).
template <int NOUT>
__device__ __forceinline__ void mma_slice(float (&acc)[2][NOUT / 32][4], const __nv_bfloat16* A,
                                          int lda, int ac, const __nv_bfloat16* B, int wm, int wn,
                                          int lane) {
  constexpr int LDB = kKS + Pad<__nv_bfloat16>::v;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kKS; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* ap = A + (wm * 32 + mt * 16 + g) * lda + ac + kk + 2 * t;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * lda);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * lda + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NOUT / 32; ++nt) {
      const __nv_bfloat16* bp = B + (wn * (NOUT / 4) + nt * 8 + g) * LDB + kk + 2 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float* c = acc[mt][nt];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]), "r"(b0), "r"(b1));
      }
    }
  }
}

// The same K-slice in full f32 on the FMA pipes.
template <int NOUT>
__device__ __forceinline__ void mma_slice(float (&acc)[2][NOUT / 32][4], const float* A, int lda,
                                          int ac, const float* B, int wm, int wn, int lane) {
  constexpr int LDB = kKS + Pad<float>::v;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < kKS; kk += 2) {
    float2 a[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* ap = A + (wm * 32 + mt * 16 + g) * lda + ac + kk;
      a[mt][0] = *reinterpret_cast<const float2*>(ap);
      a[mt][1] = *reinterpret_cast<const float2*>(ap + 8 * lda);
    }
#pragma unroll
    for (int nt = 0; nt < NOUT / 32; ++nt) {
      const float* bp = B + (wn * (NOUT / 4) + nt * 8 + 2 * t) * LDB + kk;
      const float2 b0 = *reinterpret_cast<const float2*>(bp);
      const float2 b1 = *reinterpret_cast<const float2*>(bp + LDB);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float* c = acc[mt][nt];
        c[0] = fmaf(a[mt][0].y, b0.y, fmaf(a[mt][0].x, b0.x, c[0]));
        c[1] = fmaf(a[mt][0].y, b1.y, fmaf(a[mt][0].x, b1.x, c[1]));
        c[2] = fmaf(a[mt][1].y, b0.y, fmaf(a[mt][1].x, b0.x, c[2]));
        c[3] = fmaf(a[mt][1].y, b1.y, fmaf(a[mt][1].x, b1.x, c[3]));
      }
    }
  }
}

// Stream K-slice s of a [NOUT][K] weight matrix into shared memory.
template <typename T, int NOUT>
__device__ __forceinline__ void load_slice(T* dst, const T* w, int K, int s, int tid) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = kKS / EPC;       // copies per row
  constexpr int LDB = kKS + Pad<T>::v;
  for (int i = tid; i < NOUT * CPR; i += kThreads) {
    const int row = i / CPR, c = i % CPR;
    cp_async16(dst + row * LDB + c * EPC, w + static_cast<size_t>(row) * K + s * kKS + c * EPC);
  }
}

// acc = A @ w^T over K, where A's columns [0, K0) come from A0 and the rest
// from A1 (the skip layer's [activation | segments] input, never
// concatenated). Starts and ends with the whole CTA synchronised.
template <typename T, int NOUT>
__device__ void gemm(float (&acc)[2][NOUT / 32][4], const T* A0, int lda0, int K0, const T* A1,
                     int lda1, const T* w, int K, T* ring) {
  constexpr int SLICE = NOUT * (kKS + Pad<T>::v);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NOUT / 32; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int ns = K / kKS;
  load_slice<T, NOUT>(ring, w, K, 0, tid);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      load_slice<T, NOUT>(ring + ((s + 1) & 1) * SLICE, w, K, s + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kg = s * kKS;
    if (kg < K0)
      mma_slice<NOUT>(acc, A0, lda0, kg, ring + (s & 1) * SLICE, wm, wn, lane);
    else
      mma_slice<NOUT>(acc, A1, lda1, kg - K0, ring + (s & 1) * SLICE, wm, wn, lane);
    __syncthreads();
  }
}

struct Params {
  const void* x0;   // [n][d0] segment 0, compute dtype
  const void* x1;   // [n][d1] segment 1 (d1 may be 0)
  int d0, d1, n;
  int kin;          // d0 + d1 rounded up to kKS
  int depth, skip;  // skip: index of the layer fed [act | segments], or -1
  const void* w;    // per layer [W][K_l] (K_l = kin | W | W + kin), concatenated
  const void* b;    // [depth][W] compute dtype
  const float* wd;  // [W] density head, or null
  const float* wh;  // [hf][W] f32 head block, or null
  const float* bh;  // [hf]
  int hf;
  const void* wc;   // [HC][W] compute-dtype head
  const void* bc;   // [HC]
  float* sig;       // [n] out
  float* hout;      // [n][hf] out
  void* cout;       // [n][HC] out, compute dtype
};

template <typename T, int W, int HC>
__global__ void __launch_bounds__(kThreads) trunk_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAD = Pad<T>::v;
  constexpr int LDA = W + PAD;
  const int ldi = p.kin + PAD;
  T* act = reinterpret_cast<T*>(smem);  // [kRows][LDA]
  T* inb = act + kRows * LDA;           // [kRows][ldi]
  T* ring = inb + kRows * ldi;          // 2 x [max(W, HC)][kKS + PAD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.x * kRows;
  const T* x0 = static_cast<const T*>(p.x0);
  const T* x1 = static_cast<const T*>(p.x1);
  const T* bias = static_cast<const T*>(p.b);

  // The segments, read in place from their own tensors, zero-padded to kin
  // and past the last row.
  for (int i = tid; i < kRows * p.kin; i += kThreads) {
    const int r = i / p.kin, c = i % p.kin, gr = row0 + r;
    T v = from_f<T>(0.f);
    if (gr < p.n) {
      if (c < p.d0)
        v = x0[static_cast<size_t>(gr) * p.d0 + c];
      else if (c < p.d0 + p.d1)
        v = x1[static_cast<size_t>(gr) * p.d1 + (c - p.d0)];
    }
    inb[r * ldi + c] = v;
  }

  const T* wl = static_cast<const T*>(p.w);
  for (int l = 0; l < p.depth; ++l) {
    float acc[2][W / 32][4];
    int K;
    if (l == 0) {
      K = p.kin;
      gemm<T, W>(acc, inb, ldi, K, inb, ldi, wl, K, ring);
    } else {
      K = (l == p.skip) ? W + p.kin : W;
      gemm<T, W>(acc, act, LDA, W, inb, ldi, wl, K, ring);
    }
    wl += static_cast<size_t>(W) * K;
    // gemm() ended synchronised: the activation tile may be overwritten.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < W / 32; ++nt) {
        const int col = wn * (W / 4) + nt * 8 + 2 * t;
        const T b0 = bias[l * W + col], b1 = bias[l * W + col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + g + 8 * h;
          const float z0 = fmaxf(bias_add<T>(acc[mt][nt][2 * h], b0), 0.f);
          const float z1 = fmaxf(bias_add<T>(acc[mt][nt][2 * h + 1], b1), 0.f);
          store2<T>(act + r * LDA + col, z0, z1);
        }
      }
    __syncthreads();
  }

  // f32 heads on y = act: one warp per row, lanes across the width.
  if (p.wd != nullptr || p.hf > 0) {
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const int gr = row0 + r;
      if (gr >= p.n) break;
      float y[W / 32];
#pragma unroll
      for (int i = 0; i < W / 32; ++i) y[i] = to_f(act[r * LDA + lane + 32 * i]);
      if (p.wd != nullptr) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < W / 32; ++i) s = fmaf(y[i], p.wd[lane + 32 * i], s);
        s = warp_sum(s);
        if (lane == 0) p.sig[gr] = s;
      }
      for (int j = 0; j < p.hf; ++j) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < W / 32; ++i) s = fmaf(y[i], p.wh[j * W + lane + 32 * i], s);
        s = warp_sum(s);
        if (lane == 0) p.hout[static_cast<size_t>(gr) * p.hf + j] = s + p.bh[j];
      }
    }
  }

  // Compute-dtype head (the bottleneck): one more GEMM on the resident y.
  if constexpr (HC > 0) {
    float acc[2][HC / 32][4];
    gemm<T, HC>(acc, act, LDA, W, act, LDA, static_cast<const T*>(p.wc), W, ring);
    const T* bc = static_cast<const T*>(p.bc);
    T* out = static_cast<T*>(p.cout);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < HC / 32; ++nt) {
        const int col = wn * (HC / 4) + nt * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = row0 + wm * 32 + mt * 16 + g + 8 * h;
          if (gr < p.n)
            store2<T>(out + static_cast<size_t>(gr) * HC + col,
                      bias_add<T>(acc[mt][nt][2 * h], bc[col]),
                      bias_add<T>(acc[mt][nt][2 * h + 1], bc[col + 1]));
        }
      }
  }
}

template <typename T, int W, int HC>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int PAD = Pad<T>::v;
  constexpr int NMAX = W > HC ? W : HC;
  const size_t smem = sizeof(T) * (static_cast<size_t>(kRows) * (W + PAD) +
                                   static_cast<size_t>(kRows) * (p.kin + PAD) +
                                   2 * static_cast<size_t>(NMAX) * (kKS + PAD));
  cudaError_t err = cudaFuncSetAttribute(trunk_fwd_kernel<T, W, HC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (p.n + kRows - 1) / kRows;
  trunk_fwd_kernel<T, W, HC><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int width, int hc, const Params& p, cudaStream_t stream) {
  if (width == 256 && hc == 0) return launch<T, 256, 0>(p, stream);
  if (width == 256 && hc == 128) return launch<T, 256, 128>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 on success). Allocates nothing and does not
// synchronise; runs on `stream`.
extern "C" int refnerf_trunk_fwd(int dtype, int width, int hc, const void* x0, int d0,
                                 const void* x1, int d1, int n, int kin, int depth, int skip,
                                 const void* w, const void* b, const float* wd, const float* wh,
                                 const float* bh, int hf, const void* wc, const void* bc,
                                 float* sig, float* hout, void* cout, void* stream) {
  if (n <= 0 || kin % kKS != 0 || d0 + d1 > kin) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x0, x1, d0, d1, n, kin, depth, skip, w, b, wd, wh, bh, hf, wc, bc, sig, hout, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(width, hc, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(width, hc, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Lets the wrapper refuse shapes before launching.
extern "C" int refnerf_trunk_supports(int width, int hc) {
  return width == 256 && (hc == 0 || hc == 128);
}

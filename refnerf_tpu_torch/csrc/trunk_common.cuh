// Device helpers shared by the trunk kernels (trunk_fwd.cu, trunk_bwd.cu).
//
// Tiles: a CTA owns kRows samples and runs kThreads threads, 8 warps laid
// out 2 along rows x 4 along columns. Products run on the tensor cores with
// mma.sync m16n8k16 (bf16 operands, f32 accumulation) or, in f32 mode, on
// the FMA pipes in full f32 (no TF32). Weights stream through a
// double-buffered ring of K-slices with cp.async.

#pragma once

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

// Feature-major store of a row-major shared-memory tile: dst[c * ld + r] =
// src[r * lds + c] for rows [0, kRows) and columns [0, ncols), two rows per
// thread (rows are contiguous in dst).
template <typename T>
__device__ __forceinline__ void store_fm(T* dst, size_t ld, const T* src, int lds, int ncols) {
  for (int i = threadIdx.x; i < ncols * (kRows / 2); i += kThreads) {
    const int c = i / (kRows / 2), r = 2 * (i % (kRows / 2));
    store2<T>(dst + static_cast<size_t>(c) * ld + r, to_f(src[r * lds + c]),
              to_f(src[(r + 1) * lds + c]));
  }
}

// relu' masks of one layer as bits: word w of row r holds columns
// [32 w, 32 w + 32) of act > 0. One ballot per (row, word).
template <typename T, int W>
__device__ __forceinline__ void save_mask(uint32_t* bits, const T* act, int lda) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < kRows * (W / 32); i += kThreads / 32) {
    const int r = i / (W / 32), w = i % (W / 32);
    const uint32_t b = __ballot_sync(0xffffffffu, to_f(act[r * lda + w * 32 + lane]) > 0.f);
    if (lane == 0) bits[i] = b;
  }
}

template <int W>
__device__ __forceinline__ bool mask_at(const uint32_t* bits, int r, int c) {
  return (bits[r * (W / 32) + (c >> 5)] >> (c & 31)) & 1u;
}

}  // namespace

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

// ---------------------------------------------------------------------------
// The fused directional stages of the directional trunk (fused_mlp.py
// `ide`, `ide_geo`, `rgbe` modes): K8 the integrated directional encoding
// (IDE) from refdirs and kappa_inv, K9 the direction geometry from grad_pred
// and viewdirs, K10 the colour epilogue after the rgb head. All in f32, per
// sample; ~2 kFLOP a sample against the trunk's ~1.1 MFLOP, so they ride in
// the trunk kernels for the device-memory traffic they save (the 73-wide
// encoding and its cotangent never leave the CTA), not for their own time.
// The trunk kernels take them in a template instance of their own (DIR), so
// the other modes' code is the same as without them.
//
// The products and sums of the running powers, the geometry and the
// epilogue go through __fmul_rn/__fadd_rn/__fsub_rn, so nvcc does not fuse
// them into FMAs and they round as the plain PyTorch version does.

constexpr float kEps = 1.1920928955078125e-07f;  // float32 eps (`_L2N_EPS`)
constexpr float kLog3 = 1.0986123f;               // float32(log 3)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sigm(float x) { return 1.f / add(1.f, expf(-x)); }
// d maximum(x, c)/dx with JAX's tie rule: 1 above, 1/2 at the tie, 0 below.
__device__ __forceinline__ float above(float x, float c) {
  return x > c ? 1.f : (x == c ? 0.5f : 0.f);
}

struct DirIn {
  const float* g;    // [n][3] refdirs; grad_pred in geo mode
  const float* v;    // [n][3] viewdirs (geo mode)
  const float* k;    // [n] kappa_inv
  const float* mat;  // [lmax + 1][p] z-polynomial coefficients (ide_tables)
  const float* sg;   // [p] vMF attenuation sigmas
  const float* gm;   // [lmax + 1][p] {0, 1}: harmonic i takes power m_i of x + iy
  int p;             // harmonics; 0: no fused IDE
  int lmax, geo;
  // Columns of the IDE block in the trunk input: re p | im p | n.v (geo).
  __host__ __device__ int width() const { return p ? 2 * p + geo : 0; }
};

// K9 forward intermediates of one sample.
struct Geo {
  float n[3], mv[3], dnm, den, s;
};

// refdirs and n.v from grad_pred g and viewdirs v (`_dir_geometry` :355):
// n = -g / sqrt(max(|g|^2, eps)), refdirs = 2 (n.(-v)) n + v, n.v.
__device__ __forceinline__ void dir_geometry(const float g[3], const float v[3], float r[3],
                                             float& nd, Geo& q) {
  q.s = add(add(mul(g[0], g[0]), mul(g[1], g[1])), mul(g[2], g[2]));
  q.den = sqrtf(fmaxf(q.s, kEps));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q.n[c] = __fdiv_rn(-g[c], q.den);
    q.mv[c] = -v[c];
  }
  q.dnm = add(add(mul(q.n[0], q.mv[0]), mul(q.n[1], q.mv[1])), mul(q.n[2], q.mv[2]));
  const float a = mul(2.f, q.dnm);
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = sub(mul(a, q.n[c]), q.mv[c]);
  nd = add(add(mul(q.n[0], v[0]), mul(q.n[1], v[1])), mul(q.n[2], v[2]));
}

// d grad_pred from the cotangents of refdirs and n.v (the vjp of :810-816),
// with JAX's tie rule at |g|^2 = eps.
__device__ __forceinline__ void dir_geometry_vjp(const float g[3], const float v[3], const Geo& q,
                                                 const float dr[3], float dnd, float dg[3]) {
  const float a = 2.f * q.dnm;
  const float ddnm = 2.f * (dr[0] * q.n[0] + dr[1] * q.n[1] + dr[2] * q.n[2]);
  float dn[3], dden = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dn[c] = dr[c] * a + ddnm * q.mv[c] + dnd * v[c];
    dden += dn[c] * g[c];
  }
  // n = (-g) / den: d den = sum(dn g) / den^2; den = sqrt(max(s, eps)).
  const float ds = dden / (q.den * q.den) * 0.5f / q.den * above(q.s, kEps);
#pragma unroll
  for (int c = 0; c < 3; ++c) dg[c] = -dn[c] / q.den + 2.f * g[c] * ds;
}

// One harmonic i of the IDE at direction (x, y, z): the running powers z^k
// and (x + iy)^k of `_ide_powers` :382, contracted with column i of `mat`
// and gathered by `gm`. Also the derivative of the z-polynomial and the
// power m_i - 1 of x + iy, for the closed-form backward.
struct Harm {
  float zp, dzp, re, im, re1, im1, m;
};

__device__ __forceinline__ Harm ide_harmonic(const DirIn& d, float x, float y, float z, int i) {
  Harm h{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float zk = 1.f, zk1 = 0.f, re = 1.f, im = 0.f, re1 = 0.f, im1 = 0.f;
  for (int k = 0; k <= d.lmax; ++k) {
    const float c = __ldg(d.mat + k * d.p + i);
    h.zp = fmaf(c, zk, h.zp);
    h.dzp = fmaf(c * static_cast<float>(k), zk1, h.dzp);
    if (__ldg(d.gm + k * d.p + i) != 0.f) {
      h.re = re, h.im = im, h.re1 = re1, h.im1 = im1, h.m = static_cast<float>(k);
    }
    zk1 = zk;
    zk = mul(zk, z);
    const float nre = sub(mul(re, x), mul(im, y));
    const float nim = add(mul(re, y), mul(im, x));
    re1 = re, im1 = im, re = nre, im = nim;
  }
  return h;
}

// A sample's direction (refdirs, or made from grad_pred and viewdirs), its
// kappa_inv and n.v (geo mode); rows at or past n read as zeros.
struct DirSample {
  float g[3], v[3], rd[3], ki, nd;
  Geo q;
  bool live;
};

__device__ __forceinline__ DirSample load_dir(const DirIn& d, int gr, int n) {
  DirSample s{};
  s.live = gr < n;
  if (!s.live) return s;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.g[c] = d.g[static_cast<size_t>(gr) * 3 + c];
    s.v[c] = d.geo ? d.v[static_cast<size_t>(gr) * 3 + c] : 0.f;
    s.rd[c] = s.g[c];
  }
  s.ki = d.k[gr];
  if (d.geo) dir_geometry(s.g, s.v, s.rd, s.nd, s.q);
  return s;
}

// K8/K9 forward: the IDE block of rows [row0, row0 + kRows) into columns
// [c0, c0 + d.width()) of the input tile, in the compute dtype (the
// rounding of :540-544). Four threads per row, each a quarter of the
// harmonics.
template <typename T>
__device__ void ide_fill(const DirIn& d, T* inb, int ldi, int c0, int row0, int n) {
  static_assert(kRows * 4 == kThreads, "four threads per row");
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const DirSample s = load_dir(d, row0 + r, n);
  T* row = inb + r * ldi + c0;
  for (int i = q; i < d.p; i += 4) {
    const Harm h = ide_harmonic(d, s.rd[0], s.rd[1], s.rd[2], i);
    const float zpat = h.zp * expf(mul(-s.ki, __ldg(d.sg + i)));
    row[i] = from_f<T>(s.live ? h.re * zpat : 0.f);
    row[d.p + i] = from_f<T>(s.live ? h.im * zpat : 0.f);
  }
  if (d.geo && q == 0) row[2 * d.p] = from_f<T>(s.live ? s.nd : 0.f);
}

// K8/K9 backward: from the f32 cotangents of the IDE block, dsh [kRows][ld]
// (re p | im p | n.v), the closed-form IDE backward (`_ide_bwd` :423):
//   d kappa_inv = -sum_i gmix_i zpat_i sigma_i,   gmix = g_re Re + g_im Im,
//   d z = sum_i gmix_i at_i zp'_i,
//   d x = sum_i m_i (g_re_i zpat_i Re^(m_i - 1) + g_im_i zpat_i Im^(m_i - 1)),
//   d y = sum_i m_i (g_im_i zpat_i Re^(m_i - 1) - g_re_i zpat_i Im^(m_i - 1));
// then in geo mode the geometry's vjp to d grad_pred. Writes dg [n][3] (d
// refdirs or d grad_pred) and dk [n] in f32.
__device__ void ide_backward(const DirIn& d, const float* dsh, int ld, int row0, int n, float* dg,
                             float* dk) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3, gr = row0 + r;
  const DirSample s = load_dir(d, gr, n);
  const float* cot = dsh + r * ld;
  float dx = 0.f, dy = 0.f, dz = 0.f, dki = 0.f;
  for (int i = q; i < d.p; i += 4) {
    const Harm h = ide_harmonic(d, s.rd[0], s.rd[1], s.rd[2], i);
    const float sgi = __ldg(d.sg + i);
    const float at = expf(mul(-s.ki, sgi));
    const float zpat = h.zp * at;
    const float gre = cot[i], gim = cot[d.p + i];
    const float gmix = gre * h.re + gim * h.im;
    dki -= gmix * zpat * sgi;
    dz += gmix * at * h.dzp;
    const float dre = gre * zpat, dim = gim * zpat;
    dx += h.m * (dre * h.re1 + dim * h.im1);
    dy += h.m * (dim * h.re1 - dre * h.im1);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    dx += __shfl_xor_sync(0xffffffffu, dx, o);
    dy += __shfl_xor_sync(0xffffffffu, dy, o);
    dz += __shfl_xor_sync(0xffffffffu, dz, o);
    dki += __shfl_xor_sync(0xffffffffu, dki, o);
  }
  if (!s.live || q != 0) return;
  float out[3] = {dx, dy, dz};
  if (d.geo) {
    const float drd[3] = {dx, dy, dz};
    dir_geometry_vjp(s.g, s.v, s.q, drd, cot[2 * d.p], out);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) dg[static_cast<size_t>(gr) * 3 + c] = out[c];
  dk[gr] = dki;
}

// K10: the colour epilogue (`_rgb_epilogue` :283-299).
struct Rgbe {
  const float* rawd;  // [n][3] raw diffuse
  const float* rawt;  // [n][3] raw tint
  float premult, bias, pad;
};

__device__ __forceinline__ float linear_to_srgb(float x) {
  return x <= 0.0031308f ? mul(12.92f, x)
                         : (211.f * powf(fmaxf(kEps, x), 5.f / 12.f) - 11.f) / 200.f;
}

// rgb = clip(srgb(q / max(max_c q_c, 1)), 0, 1) (1 + 2 pad) - pad with
// q = sigmoid(premult raw + bias) sigmoid(raw tint) + sigmoid(raw diffuse -
// log 3); with `ct` non-null also the vjp with JAX's tie rules (a max tied
// between channels splits equally; maximum(max, 1) and the clip at 0 and 1
// pass half at their ties): adds d raw to draw, writes d raw diffuse and d
// raw tint.
__device__ __forceinline__ void rgb_epilogue(const float raw[3], const float rd[3],
                                             const float rt[3], const Rgbe& e, float out[3],
                                             const float* ct, float draw[3], float drd[3],
                                             float drt[3]) {
  float s[3], t[3], dl[3], qv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s[c] = sigm(add(mul(e.premult, raw[c]), e.bias));
    dl[c] = sigm(sub(rd[c], kLog3));
    t[c] = sigm(rt[c]);
    qv[c] = add(mul(t[c], s[c]), dl[c]);
  }
  const float mx = fmaxf(fmaxf(qv[0], qv[1]), qv[2]);
  const float nrm = fmaxf(mx, 1.f);
  const float scale = add(1.f, mul(2.f, e.pad));
  float rr[3], lin[3], cl[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rr[c] = __fdiv_rn(qv[c], nrm);
    lin[c] = linear_to_srgb(rr[c]);
    cl[c] = fmaxf(lin[c], 0.f);
    out[c] = sub(mul(fminf(cl[c], 1.f), scale), e.pad);
  }
  if (ct == nullptr) return;
  float dq[3], dnrm = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // minimum(maximum(L, 0), 1): half at either tie.
    const float dlin = ct[c] * scale * (cl[c] < 1.f ? 1.f : (cl[c] == 1.f ? 0.5f : 0.f)) *
                       above(lin[c], 0.f);
    const float dr = rr[c] <= 0.0031308f
                         ? dlin * 12.92f
                         : dlin / 200.f * 211.f * (5.f / 12.f) * powf(rr[c], 5.f / 12.f - 1.f);
    dq[c] = dr / nrm;
    dnrm -= dr * qv[c] / (nrm * nrm);
  }
  const float dmx = dnrm * above(mx, 1.f);
  const float ties = (qv[0] == mx) + (qv[1] == mx) + (qv[2] == mx);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (qv[c] == mx) dq[c] += dmx / ties;
    draw[c] += dq[c] * t[c] * s[c] * (1.f - s[c]) * e.premult;
    drd[c] = dq[c] * dl[c] * (1.f - dl[c]);
    drt[c] = dq[c] * s[c] * t[c] * (1.f - t[c]);
  }
}

// The trunk input tile of rows [row0, row0 + kRows): columns [x0 (d0) |
// fused IDE block | x1 (d1)], zero-padded to kin and past row n. Without
// DIR (every mode but K8-K10) there is no IDE block and none of its code.
template <typename T, bool DIR>
__device__ void load_input(T* inb, int ldi, const T* x0, int d0, const T* x1, int d1, int kin,
                           int row0, int n, const DirIn& dir) {
  const int dide = DIR ? dir.width() : 0;
  for (int i = threadIdx.x; i < kRows * kin; i += kThreads) {
    const int r = i / kin, c = i % kin, gr = row0 + r, c1 = c - d0 - dide;
    if (DIR && c >= d0 && c1 < 0) continue;  // the IDE block, filled below
    T v = from_f<T>(0.f);
    if (gr < n) {
      if (c < d0)
        v = x0[static_cast<size_t>(gr) * d0 + c];
      else if (c1 < d1)
        v = x1[static_cast<size_t>(gr) * d1 + c1];
    }
    inb[r * ldi + c] = v;
  }
  if constexpr (DIR) {
    if (dir.p) ide_fill<T>(dir, inb, ldi, d0, row0, n);
  }
}

// ---------------------------------------------------------------------------
// The fused spatial stages of the spatial trunk (fused_mlp.py `encode` and
// `weights` modes): K7 the IPE made in the CTA from the lifted means and
// variances, K6 the compositing weights after the density head. Both in
// f32. K7 reads 24 B a sample instead of the 192 B of the bf16 encoding (96
// columns) and costs 48 sincos + exp a sample on the FMA pipes, against the
// trunk's ~1.1 MFLOP on the tensor cores; K6 is a scan of S values a ray.
// The trunk kernels take them in a template instance of their own (SPA).

constexpr float kTrigT = 314.159265358979323846f;  // float32(100 pi) (`_TRIG_T`)

// K7: the raw inputs. Column c of either segment is degree c / nb of basis
// vector c % nb, scaled by fold[c][c % nb] (the scale fold S, a power of two).
struct Ipe {
  const float* lm;    // [n][nb] lifted means
  const float* lv;    // [n][nb] lifted variances
  const float* fold;  // [F][nb]
  int nb;
};

// e = exp(-v / 2), sin m, cos m of column c of row gr (`_segments` :550-563):
// m = lm s, v = lv s^2, exact products of powers of two; m range-reduced as
// `_safe_trig_arg` :191 and torch.remainder do (fmod, plus t where the sign
// differs), in full precision (sincosf, expf; no fast-math intrinsics).
__device__ __forceinline__ void ipe_trig(const Ipe& q, int gr, int c, float& e, float& sn,
                                         float& cs) {
  const int j = c % q.nb;
  const float s = __ldg(q.fold + c * q.nb + j);
  const size_t o = static_cast<size_t>(gr) * q.nb + j;
  float m = mul(q.lm[o], s);
  e = expf(mul(-0.5f, mul(q.lv[o], mul(s, s))));
  if (!(fabsf(m) < kTrigT)) {
    float r = fmodf(m, kTrigT);
    if (r != 0.f && r < 0.f) r = add(r, kTrigT);
    m = r;
  }
  sincosf(m, &sn, &cs);
}

// K7 forward: the input tile of rows [row0, row0 + kRows): columns [xs F |
// xc F], xs = cdt(e sin m), xc = cdt(e cos m), zero-padded to kin and past
// row n.
template <typename T>
__device__ void load_ipe(T* inb, int ldi, const Ipe& q, int F, int kin, int row0, int n) {
  for (int i = threadIdx.x; i < kRows * kin; i += kThreads) {
    const int r = i / kin, c = i % kin, gr = row0 + r;
    if (gr < n && c < F) {
      float e, sn, cs;
      ipe_trig(q, gr, c, e, sn, cs);
      inb[r * ldi + c] = from_f<T>(mul(e, sn));
      inb[r * ldi + F + c] = from_f<T>(mul(e, cs));
    } else if (gr >= n || c >= 2 * F) {
      inb[r * ldi + c] = from_f<T>(0.f);
    }
  }
}

// K6: sigma = softplus(raw + bsig), dd = sigma delta, T = exp(-excl) with
// excl the exclusive prefix sum of dd along the ray, w = (1 - exp(-dd)) T
// (`_epilogue_fwd` :498). One warp a ray: lane L owns the consecutive
// samples [L k, L k + k), k = ceil(S / 32), and the lanes' sums are scanned
// by shuffles. softplus as torch's (threshold 20).
__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(expf(x)); }

// The sum of v over the lanes below this one.
__device__ __forceinline__ float warp_prefix(float v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = add(v, u);
  }
  const float ex = __shfl_up_sync(0xffffffffu, v, 1);
  return lane == 0 ? 0.f : ex;
}

// The sum of v over the lanes above this one.
__device__ __forceinline__ float warp_suffix(float v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v = add(v, u);
  }
  const float ex = __shfl_down_sync(0xffffffffu, v, 1);
  return lane == 31 ? 0.f : ex;
}

__device__ __forceinline__ float ray_dd(const float* raw, const float* delta, float bsig, int i) {
  return mul(softplus(add(raw[i], bsig)), delta[i]);
}

// The weights of one ray of S samples into w[0, S); with tr non-null also
// T into tr[0, S). raw may lie in shared or device memory. Returns this
// lane's sum of wbar w over its samples when wbar is non-null.
__device__ __forceinline__ float ray_weights(const float* raw, const float* delta, float bsig,
                                             int S, float* w, float* tr, const float* wbar) {
  const int lane = threadIdx.x & 31, k = (S + 31) / 32;
  const int i0 = min(S, lane * k), i1 = min(S, i0 + k);
  float tot = 0.f;
  for (int i = i0; i < i1; ++i) tot = add(tot, ray_dd(raw, delta, bsig, i));
  float excl = warp_prefix(tot), xw = 0.f;
  for (int i = i0; i < i1; ++i) {
    const float dd = ray_dd(raw, delta, bsig, i), t = expf(-excl);
    const float wi = mul(sub(1.f, expf(-dd)), t);
    if (w != nullptr) w[i] = wi;
    if (tr != nullptr) tr[i] = t;
    if (wbar != nullptr) xw = add(xw, mul(wbar[i], wi));
    excl = add(excl, dd);
  }
  return xw;
}

// K6 backward (:719-741) of one ray: ct_dd = wbar (T - w) - suffix(wbar w),
// suffix the sum over the later samples, ct_raw = ct_dd delta
// sigmoid(raw + bsig). tr is S floats of scratch; ct_raw of samples
// [lo, hi) goes to ct[i].
__device__ __forceinline__ void ray_weights_vjp(const float* raw, const float* delta,
                                                const float* wbar, float bsig, int S, float* tr,
                                                int lo, int hi, float* ct) {
  const int lane = threadIdx.x & 31, k = (S + 31) / 32;
  const int i0 = min(S, lane * k), i1 = min(S, i0 + k);
  float suf = warp_suffix(ray_weights(raw, delta, bsig, S, nullptr, tr, wbar));
  for (int i = i1 - 1; i >= i0; --i) {
    const float x = add(raw[i], bsig), dd = mul(softplus(x), delta[i]);
    const float t = tr[i], wi = mul(sub(1.f, expf(-dd)), t);
    if (i >= lo && i < hi)
      ct[i] = mul(mul(sub(mul(wbar[i], sub(t, wi)), suf), delta[i]), sigm(x));
    suf = add(suf, mul(wbar[i], wi));
  }
}

}  // namespace

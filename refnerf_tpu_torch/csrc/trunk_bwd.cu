// Layer-fused dense trunk backward for Hopper (sm_90a).
//
// Replaces the backward Pallas kernel `_bwd_kernel` (:668-853) of
// refnerf_tpu/ops/pallas/fused_mlp.py in these modes:
//   K4  spatial trunk (`fused_encoded_trunk` with `density_grad`): cotangents
//       of sigma, the f32 head block, the compute-dtype bottleneck and u;
//       first- and second-order parameter gradients in one pass;
//   K5  directional trunk (`fused_trunk`, `needs_dx`): cotangent of the f32
//       rgb head; parameter gradients and each segment's cotangent;
//   K8  K5 with `ide` (:802-809, `_ide_bwd` :423): the IDE recomputed into
//       the input tile; the f32 cotangents of its 72 columns go through the
//       closed-form IDE backward in the CTA, so d refdirs and d kappa_inv
//       (4 f32 a sample) leave instead of 73 compute-dtype columns;
//   K9  K8 with `ide_geo` (:810-816): further through the geometry's vjp to
//       d grad_pred;
//   K10 K5 with `rgbe` (:752-764): the head is recomputed and the cotangent
//       of the final rgb pulled back through the colour epilogue (JAX's tie
//       rules) onto the head's cotangent, d raw diffuse and d raw tint;
//   K7  K4 with `encode` (:705-707, :829-831): the IPE recomputed into the
//       input tile from the lifted means and variances, the second-order
//       tangent ts from the f32 e cos m and e sin m;
//   K6  K4 with `weights` (:719-742): the cotangent of the compositing
//       weights becomes one of the raw density before the head backward,
//       and d bsig joins the vector gradients;
//   K11 K4 with `out_y` (:675, :717-718), first order, without the
//       compute-dtype head: the cotangent of y [n, W] (compute dtype) is
//       the first term of y's cotangent, in an instance of its own (YO).
// The directional trunk (K5) runs at width 256 and 128 (mip-NeRF), and the
// spatial trunk (K4) also first order (no ū: mip-NeRF has no density
// normals), in the instances K4 already has.
//
// What it computes, in the Pallas order and casts (fused_mlp.py :705-853):
//   recompute h_l (and, with u, the inner chain s_l = relu'(h_l) q_l);
//   g = [ybar +] cdt(cbar wc^T) + cdt(sbar wd + hbar wh^T)        (:714-775)
//   zeta_l = relu'(h_l) g,  g = cdt(zeta_l Wa_l)        l = L-1 .. 0 (:777-801)
//   dx_j = sum over the input-consuming layers of zeta_l Wx_l  (f32, :794-821)
//   t = ubar S^T;  ts = (cdt(t xc), cdt(-t xs));  p_l = relu'(h_l) cdt(t_l),
//   t_l = p_{l-1} Wa_l (+ ts Wx_l at the skip layer)             (:823-852)
//   dW_l = zeta_l^T [h_{l-1} | x] + s_l^T [p_{l-1} | ts],  db_l = sum zeta_l,
//   dwd = sum sbar y + sum p_{L-1},  dwh = hbar^T y,  dwc = cbar^T y.
//
// Design. The Pallas kernel keeps all 8 activations and all 8 s_l of a block
// in VMEM and adds every weight gradient into an output block that the
// sequential grid carries. On Hopper a 64-row tile's activations alone
// (8 x 64 x 256 bf16 = 256 KB) exceed a CTA's 227 KB of shared memory, and
// CTAs run in no order. So the work is split in two kinds of kernel:
//   1. trunk_bwd_kernel, one CTA per 64 samples: one activation-sized tile
//      resident in shared memory, the relu' masks of every layer as bits
//      (16 KB), the weights streamed through the K-slice ring of the forward
//      kernel (the reverse products read the transposed pack). Each layer's
//      weight-gradient operands (h_l, zeta_l, s_l, p_l, x, ts, cbar) go to a
//      device-memory scratch, feature-major [feature][sample] in the compute
//      dtype; the vector gradients (biases, density and f32 heads) are summed
//      over the tile into one per-tile row. dx leaves through a scalar store
//      loop, since the 73-wide IDE + n.v segment aligns to no vector width.
//   2. wgrad_kernel, a split-K product over samples: dW[o][k] = sum_n
//      Z[o][n] A[k][n] (+ S[o][n] B[k][n]) on 128 x 128 output tiles, each
//      split of samples writing its own partial; reduce_kernel then sums the
//      partials (and the per-tile vector rows) in a fixed order. No float
//      atomics anywhere, so the gradients do not depend on the schedule.
// The wrapper runs this per slab of samples so the scratch stays bounded.
// K6's backward needs sums over a whole ray, before and after each sample,
// while a 64-row tile may hold part of a ray: each CTA reads its rays' raw
// density (the forward's output), delta and weights' cotangent from device
// memory (L2-resident, 12 B a sample), scans each ray with one warp, and
// keeps the cotangents of its own rows. A slab holds whole rays.
//
// Bound on the H100: at N = 524,288 samples the spatial backward is ~6
// trunk passes (0.57 TFLOP each, `_make_op`'s own count), about 3.4 TFLOP, on
// mma.sync (bf16) or FMA (f32); the scratch adds ~17 KB per sample written
// and read back in bf16 (~9 GB at N = 524,288), a few ms at 3.35 TB/s. So
// the tensor-core throughput bounds it. wgmma/TMA, and keeping the operands
// out of device memory, are later work.

#include "trunk_common.cuh"

namespace {

constexpr int kTile = 128;  // output tile (rows x columns) of the weight-gradient product

struct BwdParams {
  const void* x0;   // [n][d0] segment 0 of this slab, compute dtype
  const void* x1;   // [n][d1] segment 1 (d1 may be 0)
  int d0, d1, n;
  int kin;          // d0 + d1 rounded up to kKS
  int depth, skip;  // skip: the layer fed [act | segments], or -1
  const void* w;    // per layer [W][K_l], concatenated (the forward pack)
  const void* wt;   // per layer [K_l][W] (W_l transposed), concatenated
  const void* b;    // [depth][W]
  const float* wd;  // [W] density head, or null
  const float* wh;  // [hf][W] f32 head block, or null
  const float* bh;  // [hf]
  int hf;
  const void* wct;    // [W][HC] compute-dtype head, transposed
  const float* sbar;  // [n] cotangent of sigma, or null
  const float* hbar;  // [n][hf] cotangent of the f32 heads, or null
  const void* cbar;   // [n][HC] cotangent of the compute-dtype head, or null
  const float* ubar;  // [n][nb] cotangent of u, or null (no second-order pass)
  const float* fold;  // [d0][nb] scale fold S
  int nb;
  void* dx0;          // [n][d0] out, compute dtype, or null (no dx)
  void* dx1;          // [n][d1] out
  float* dxs;         // [rp][kin] f32 scratch: the skip layer's share of dx
  int rp;             // scratch row stride: n rounded up to kRows
  void* hs;           // [depth][W][rp] activations h_l
  void* zs;           // [depth][W][rp] zeta_l
  void* ss;           // [depth][W][rp] s_l (with ubar)
  void* ps;           // [depth][W][rp] p_l (with ubar)
  void* xs;           // [kin][rp] trunk input
  void* ts;           // [kin][rp] its tangent ts (with ubar)
  void* cs;           // [HC][rp] cbar
  float* vec;         // [rp / kRows][nvec] per-tile vector gradients:
  int nvec;           //   db [depth][W] | dwd [W] | dwh [hf][W] | dbh [hf] | dbc [HC]
  DirIn dir;          // K8/K9: the IDE block between x0 and x1 (dir.p > 0)
  float* ddg;         // [n][3] out: d refdirs, or d grad_pred in geo mode (K8)
  float* ddk;         // [n] out: d kappa_inv (K8)
  Rgbe rgbe;          // K10, with rgb_bar non-null
  const float* rgb_bar;  // [n][3] cotangent of the final rgb
  float* drawd;       // [n][3] out: d raw diffuse
  float* drawt;       // [n][3] out: d raw tint
  Ipe ipe;            // K7 with ipe.lm non-null: (lm, lv) in place of x0, x1
  const float* delta;  // [n] K6, with sig and wbar
  const float* bsig;   // [1]
  const float* sig;    // [n] the forward's raw density
  const float* wbar;   // [n] cotangent of the weights
  int samples;         // samples a ray
  const void* ybar;    // [n][W] cotangent of y, compute dtype (K11)
};

// The accumulator of a [kRows][NOUT] gemm, rounded to the compute dtype and
// stored into a row-major shared-memory tile; `mask` keeps only relu'(h) > 0.
template <typename T, int NOUT>
__device__ __forceinline__ void store_acc(T* dst, int ld, const float (&acc)[2][NOUT / 32][4],
                                          const uint32_t* mask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NOUT / 32; ++nt) {
      const int col = wn * (NOUT / 4) + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        float a = round_t<T>(acc[mt][nt][2 * h]), b = round_t<T>(acc[mt][nt][2 * h + 1]);
        if (mask != nullptr) {
          if (!mask_at<NOUT>(mask, r, col)) a = 0.f;
          if (!mask_at<NOUT>(mask, r, col + 1)) b = 0.f;
        }
        store2<T>(dst + r * ld + col, a, b);
      }
    }
}

// Zero every element of a [kRows][W] tile whose relu' mask bit is 0.
template <typename T, int W>
__device__ __forceinline__ void apply_mask(T* act, int lda, const uint32_t* mask) {
  for (int i = threadIdx.x; i < kRows * W; i += kThreads) {
    const int r = i / W, c = i % W;
    if (!mask_at<W>(mask, r, c)) act[r * lda + c] = from_f<T>(0.f);
  }
}

// Sum of each column of a [kRows][ncols] tile, written (or added) to out.
template <typename T>
__device__ __forceinline__ void column_sums(float* out, const T* src, int lds, int ncols,
                                            bool add) {
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += to_f(src[r * lds + c]);
    out[c] = add ? out[c] + s : s;
  }
}

template <typename T, int W, int HC, bool DIR, bool SPA, bool YO = false>
__global__ void __launch_bounds__(kThreads) trunk_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAD = Pad<T>::v;
  constexpr int LDA = W + PAD;
  constexpr int MW = W / 32;  // mask words per row
  const int ldi = p.kin + PAD;
  T* act = reinterpret_cast<T*>(smem);  // [kRows][LDA]: h, s, g, zeta, p in turn
  T* inb = act + kRows * LDA;           // [kRows][ldi]: x, then ts
  T* ring = inb + kRows * ldi;          // 2 x [W][kKS + PAD]
  uint32_t* bits = reinterpret_cast<uint32_t*>(ring + 2 * W * (kKS + PAD));  // [depth][kRows][MW]
  float* sb = reinterpret_cast<float*>(bits + p.depth * kRows * MW);        // [kRows]
  float* hb = sb + kRows;                                                   // [kRows][hf]
  float* ub = hb + kRows * p.hf;                                            // [kRows][nb]
  // K8: the IDE block's f32 cotangents [kRows][dir.width()], in the input
  // tile's space once the first-order reverse no longer reads x.
  [[maybe_unused]] float* dsh = reinterpret_cast<float*>(inb);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.x * kRows;
  const size_t rp = static_cast<size_t>(p.rp);
  const bool dg = p.ubar != nullptr;
  const T* x0 = static_cast<const T*>(p.x0);
  const T* x1 = static_cast<const T*>(p.x1);
  const T* bias = static_cast<const T*>(p.b);
  const T* w = static_cast<const T*>(p.w);
  const T* wt = static_cast<const T*>(p.wt);
  T* hs = static_cast<T*>(p.hs) + row0;
  T* zs = static_cast<T*>(p.zs) + row0;
  T* ss = static_cast<T*>(p.ss) + row0;
  T* ps = static_cast<T*>(p.ps) + row0;
  float* vec = p.vec + static_cast<size_t>(blockIdx.x) * p.nvec;
  const int o_dwd = p.depth * W;
  const int o_dwh = o_dwd + (p.wd != nullptr ? W : 0);
  const int o_dbh = o_dwh + p.hf * W;
  const int o_dbc = o_dbh + p.hf;
  [[maybe_unused]] const int o_dbsig = o_dbc + HC;

  size_t off[16];  // each layer's block in the packs
  {
    size_t o = 0;
    for (int l = 0; l < p.depth; ++l) {
      off[l] = o;
      o += static_cast<size_t>(W) * (l == 0 ? p.kin : (l == p.skip ? W + p.kin : W));
    }
  }

  // 1. The segments (with K8 the IDE block, with K7 the IPE; zero-padded to
  // kin and past the last row) and the cotangents; x to the scratch.
  if constexpr (SPA) {
    if (p.ipe.lm != nullptr)
      load_ipe<T>(inb, ldi, p.ipe, p.d0, p.kin, row0, p.n);
    else
      load_input<T, false>(inb, ldi, x0, p.d0, x1, p.d1, p.kin, row0, p.n, p.dir);
  } else {
    load_input<T, DIR>(inb, ldi, x0, p.d0, x1, p.d1, p.kin, row0, p.n, p.dir);
  }
  for (int r = tid; r < kRows; r += kThreads)
    sb[r] = (p.sbar != nullptr && row0 + r < p.n) ? p.sbar[row0 + r] : 0.f;
  for (int i = tid; i < kRows * p.hf; i += kThreads)
    hb[i] = (p.hbar != nullptr && row0 + i / p.hf < p.n)
                ? p.hbar[static_cast<size_t>(row0) * p.hf + i] : 0.f;
  if (dg)
    for (int i = tid; i < kRows * p.nb; i += kThreads)
      ub[i] = row0 + i / p.nb < p.n ? p.ubar[static_cast<size_t>(row0) * p.nb + i] : 0.f;
  __syncthreads();
  store_fm<T>(static_cast<T*>(p.xs) + row0, rp, inb, ldi, p.kin);

  // 1b. K6: sbar += ct_raw of this tile's rows and d bsig, their sum in row
  // order. The rays that overlap the tile, one warp a ray, with S floats of
  // scratch a warp and the tile's ct_raw in the activation tile's space
  // (free until the recompute).
  if constexpr (SPA) {
    if (p.wbar != nullptr) {
      const int S = p.samples, hi = min(row0 + kRows, p.n);
      float* ct = reinterpret_cast<float*>(act);  // [kRows]
      float* tr = ct + kRows + warp * S;          // [S] a warp
      for (int r = tid; r < kRows; r += kThreads) ct[r] = 0.f;
      __syncthreads();
      const float bsig = __ldg(p.bsig);
      for (int q = row0 / S + warp; q * S < hi; q += kThreads / 32) {
        const int r0 = q * S;
        ray_weights_vjp(p.sig + r0, p.delta + r0, p.wbar + r0, bsig, S, tr,
                        max(row0, r0) - r0, min(hi, r0 + S) - r0, ct + (r0 - row0));
      }
      __syncthreads();
      for (int r = tid; r < kRows; r += kThreads) sb[r] = add(sb[r], ct[r]);
      if (tid == 0) {
        float s = 0.f;
        for (int r = 0; r < kRows; ++r) s = add(s, ct[r]);
        vec[o_dbsig] = s;
      }
      __syncthreads();
    }
  }

  // 2. Recompute the trunk: h_l to the scratch, relu' masks as bits.
  for (int l = 0; l < p.depth; ++l) {
    float acc[2][W / 32][4];
    const int K = l == 0 ? p.kin : (l == p.skip ? W + p.kin : W);
    if (l == 0)
      gemm<T, W>(acc, inb, ldi, K, inb, ldi, w + off[l], K, ring);
    else
      gemm<T, W>(acc, act, LDA, W, inb, ldi, w + off[l], K, ring);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < W / 32; ++nt) {
        const int col = wn * (W / 4) + nt * 8 + 2 * t;
        const T b0 = bias[l * W + col], b1 = bias[l * W + col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + g + 8 * h;
          store2<T>(act + r * LDA + col, fmaxf(bias_add<T>(acc[mt][nt][2 * h], b0), 0.f),
                    fmaxf(bias_add<T>(acc[mt][nt][2 * h + 1], b1), 0.f));
        }
      }
    __syncthreads();
    save_mask<T, W>(bits + l * kRows * MW, act, LDA);
    store_fm<T>(hs + l * W * rp, rp, act, LDA, W);
  }

  // 2b. K10: the head recomputed on y and the cotangent of the final rgb
  // pulled back through the colour epilogue onto the head's cotangent.
  if constexpr (DIR) {
    if (p.rgb_bar != nullptr) {
      for (int r = warp; r < kRows; r += kThreads / 32) {
        const int gr = row0 + r;
        if (gr >= p.n) break;
        float hv[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < W / 32; ++i)
            s = fmaf(to_f(act[r * LDA + lane + 32 * i]), p.wh[j * W + lane + 32 * i], s);
          hv[j] = warp_sum(s) + p.bh[j];
        }
        if (lane == 0) {
          const size_t o = static_cast<size_t>(gr) * 3;
          float out[3], drd[3], drt[3];
          rgb_epilogue(hv, p.rgbe.rawd + o, p.rgbe.rawt + o, p.rgbe, out, p.rgb_bar + o,
                       hb + r * 3, drd, drt);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            p.drawd[o + c] = drd[c];
            p.drawt[o + c] = drt[c];
          }
        }
      }
      __syncthreads();
    }
  }

  // 3. The head gradients that read y (still resident): dwd, dwh, dbh.
  for (int c = tid; c < W; c += kThreads) {
    if (p.wd != nullptr) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(sb[r], to_f(act[r * LDA + c]), s);
      vec[o_dwd + c] = s;
    }
    for (int j = 0; j < p.hf; ++j) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(hb[r * p.hf + j], to_f(act[r * LDA + c]), s);
      vec[o_dwh + j * W + c] = s;
    }
  }
  for (int j = tid; j < p.hf; j += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += hb[r * p.hf + j];
    vec[o_dbh + j] = s;
  }
  __syncthreads();

  // 4. With the cotangent of u: the inner chain's s_l to the scratch
  // (q = cdt(wd); s_l = relu'(h_l) q; q = cdt(s_l Wa_l)).
  if (dg) {
    for (int i = tid; i < kRows * W; i += kThreads)
      act[(i / W) * LDA + i % W] = from_f<T>(p.wd[i % W]);
    __syncthreads();
    for (int l = p.depth - 1; l >= 0; --l) {
      apply_mask<T, W>(act, LDA, bits + l * kRows * MW);
      __syncthreads();
      store_fm<T>(ss + l * W * rp, rp, act, LDA, W);
      if (l > 0) {
        float acc[2][W / 32][4];
        gemm<T, W>(acc, act, LDA, W, act, LDA, wt + off[l], W, ring);
        store_acc<T, W>(act, LDA, acc, nullptr);
      }
      __syncthreads();
    }
  }

  // 5. The head backward: g = cdt(cbar wc^T) + cdt(g32), g32 = sbar wd +
  // hbar wh^T (in f32 mode, exactly acc + g32); with K11 (no cbar) g =
  // cdt(ybar + cdt(g32)), ybar first as in :717-718.
  auto g32 = [&](int r, int c) {
    float back = 0.f;
    for (int j = 0; j < p.hf; ++j) back = fmaf(hb[r * p.hf + j], p.wh[j * W + c], back);
    return p.wd != nullptr ? sb[r] * p.wd[c] + back : back;
  };
  if constexpr (HC > 0) {
    const T* cbar = static_cast<const T*>(p.cbar);
    for (int i = tid; i < kRows * HC; i += kThreads) {
      const int r = i / HC, c = i % HC;
      act[r * LDA + c] = (cbar != nullptr && row0 + r < p.n)
                             ? cbar[static_cast<size_t>(row0 + r) * HC + c] : from_f<T>(0.f);
    }
    __syncthreads();
    store_fm<T>(static_cast<T*>(p.cs) + row0, rp, act, LDA, HC);
    column_sums<T>(vec + o_dbc, act, LDA, HC, false);
    float acc[2][W / 32][4];
    gemm<T, W>(acc, act, LDA, HC, act, LDA, static_cast<const T*>(p.wct), HC, ring);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < W / 32; ++nt) {
        const int col = wn * (W / 4) + nt * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + g + 8 * h;
          store2<T>(act + r * LDA + col,
                    round_t<T>(round_t<T>(acc[mt][nt][2 * h]) + round_t<T>(g32(r, col))),
                    round_t<T>(round_t<T>(acc[mt][nt][2 * h + 1]) + round_t<T>(g32(r, col + 1))));
        }
      }
  } else {
    for (int i = tid; i < kRows * W; i += kThreads) {
      const int r = i / W, c = i % W;
      if constexpr (YO) {
        const float yb = row0 + r < p.n
            ? to_f(static_cast<const T*>(p.ybar)[static_cast<size_t>(row0 + r) * W + c])
            : 0.f;
        act[r * LDA + c] = from_f<T>(yb + round_t<T>(g32(r, c)));
      } else {
        act[r * LDA + c] = from_f<T>(g32(r, c));
      }
    }
  }
  __syncthreads();

  // 6. The first-order reverse: zeta_l, db_l, dx, g.
  for (int l = p.depth - 1; l >= 0; --l) {
    apply_mask<T, W>(act, LDA, bits + l * kRows * MW);
    __syncthreads();
    store_fm<T>(zs + l * W * rp, rp, act, LDA, W);
    column_sums<T>(vec + l * W, act, LDA, W, false);
    if (p.dx0 != nullptr && (l == 0 || l == p.skip)) {
      // dx = (0 + zeta_skip Wx_skip) + zeta_0 Wx_0, accumulated in f32 in the
      // Pallas order; the skip layer's share waits in the f32 scratch. With
      // K8 the IDE block's f32 cotangents go to dsh (the input tile's space,
      // free now) for the IDE backward below.
      const int base = l == 0 ? 0 : W;
      const int dide = DIR ? p.dir.width() : 0, fin = p.d0 + dide + p.d1;
      for (int c0 = 0; c0 < p.kin; c0 += 32) {
        float acc[2][1][4];
        gemm<T, 32>(acc, act, LDA, W, act, LDA, wt + off[l] + static_cast<size_t>(base + c0) * W,
                    W, ring);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = wm * 32 + mt * 16 + g + 8 * (i >> 1);
            const int c = c0 + wn * 8 + 2 * t + (i & 1);
            float* keep = p.dxs + static_cast<size_t>(row0 + r) * p.kin + c;
            if (l != 0) {
              *keep = acc[mt][0][i];
              continue;
            }
            const float v = p.skip >= 0 ? *keep + acc[mt][0][i] : acc[mt][0][i];
            const size_t gr = static_cast<size_t>(row0 + r);
            const int ci = c - p.d0;
            if (DIR && ci >= 0 && ci < dide) {
              dsh[r * dide + ci] = v;
              continue;
            }
            if (row0 + r >= p.n || c >= fin) continue;
            if (c < p.d0)
              static_cast<T*>(p.dx0)[gr * p.d0 + c] = from_f<T>(v);
            else
              static_cast<T*>(p.dx1)[gr * p.d1 + (ci - dide)] = from_f<T>(v);
          }
      }
    }
    if (l > 0) {
      float acc[2][W / 32][4];
      gemm<T, W>(acc, act, LDA, W, act, LDA, wt + off[l], W, ring);
      store_acc<T, W>(act, LDA, acc, nullptr);
    }
    __syncthreads();
  }

  // 6b. K8/K9: the IDE block's cotangents back to the raw inputs.
  if constexpr (DIR) {
    if (p.dir.p) ide_backward(p.dir, dsh, p.dir.width(), row0, p.n, p.ddg, p.ddk);
  }

  // 7. With the cotangent of u: the tangent chain (:823-853). ts replaces x
  // in the input tile, element by element.
  if (!dg) return;
  const int F = p.d0;
  for (int i = tid; i < kRows * F; i += kThreads) {
    const int r = i / F, c = i % F;
    float tp = 0.f;
    for (int j = 0; j < p.nb; ++j) tp = fmaf(ub[r * p.nb + j], p.fold[c * p.nb + j], tp);
    if constexpr (SPA) {
      if (p.ipe.lm != nullptr) {  // K7: ts = (tp e cos m, -(tp e sin m)), f32 factors
        float e = 0.f, sn = 0.f, cs = 0.f;
        if (row0 + r < p.n) ipe_trig(p.ipe, row0 + r, c, e, sn, cs);
        const float te = mul(tp, e);
        inb[r * ldi + c] = from_f<T>(mul(te, cs));
        inb[r * ldi + F + c] = from_f<T>(-mul(te, sn));
        continue;
      }
    }
    const float xs = to_f(inb[r * ldi + c]), xc = to_f(inb[r * ldi + F + c]);
    inb[r * ldi + c] = from_f<T>(tp * xc);
    inb[r * ldi + F + c] = from_f<T>(-(tp * xs));
  }
  __syncthreads();
  store_fm<T>(static_cast<T*>(p.ts) + row0, rp, inb, ldi, p.kin);
  for (int l = 0; l < p.depth; ++l) {
    float acc[2][W / 32][4];
    const int K = l == 0 ? p.kin : (l == p.skip ? W + p.kin : W);
    if (l == 0)
      gemm<T, W>(acc, inb, ldi, K, inb, ldi, w + off[l], K, ring);
    else
      gemm<T, W>(acc, act, LDA, W, inb, ldi, w + off[l], K, ring);
    store_acc<T, W>(act, LDA, acc, bits + l * kRows * MW);
    __syncthreads();
    if (l + 1 < p.depth)
      store_fm<T>(ps + l * W * rp, rp, act, LDA, W);
    else
      column_sums<T>(vec + o_dwd, act, LDA, W, true);
  }
}

template <typename T, int W, int HC, bool DIR, bool SPA, bool YO = false>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  constexpr int PAD = Pad<T>::v;
  const size_t smem = sizeof(T) * (static_cast<size_t>(kRows) * (W + PAD) +
                                   static_cast<size_t>(kRows) * (p.kin + PAD) +
                                   2 * static_cast<size_t>(W) * (kKS + PAD)) +
                      4 * (static_cast<size_t>(p.depth) * kRows * (W / 32) +
                           static_cast<size_t>(kRows) * (1 + p.hf + p.nb));
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  // K6's scratch: [kRows] + [8 warps][S] floats in the activation tile.
  if (SPA && p.wbar != nullptr &&
      4 * (kRows + (kThreads / 32) * static_cast<size_t>(p.samples)) >
          sizeof(T) * kRows * (W + PAD))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(trunk_bwd_kernel<T, W, HC, DIR, SPA, YO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_bwd_kernel<T, W, HC, DIR, SPA, YO><<<p.rp / kRows, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K8-K10 run on the directional trunk only (no compute-dtype head), K6 and
// K7 on the spatial trunk with its bottleneck head, K11 on the spatial trunk
// without it and without ū; their code is built into the DIR, SPA and YO
// instances alone. Width 128 is the plain directional trunk (K5) alone: no
// density head, ū, compute-dtype head or fused stage, which were never
// checked there.
template <typename T>
int dispatch_bwd(int width, int hc, const BwdParams& p, cudaStream_t stream) {
  const bool dir = p.dir.p != 0 || p.rgb_bar != nullptr;
  const bool spa = p.ipe.lm != nullptr || p.wbar != nullptr;
  if (p.ybar != nullptr)
    return width == 256 && hc == 0 && !dir && !spa && p.ubar == nullptr
               ? launch_bwd<T, 256, 0, false, false, true>(p, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  if (width == 128)
    return hc == 0 && !dir && !spa && p.ubar == nullptr && p.wd == nullptr
               ? launch_bwd<T, 128, 0, false, false>(p, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  if (width == 256 && hc == 0 && !spa)
    return dir ? launch_bwd<T, 256, 0, true, false>(p, stream)
               : launch_bwd<T, 256, 0, false, false>(p, stream);
  if (width == 256 && hc == 128 && !dir)
    return spa ? launch_bwd<T, 256, 128, false, true>(p, stream)
               : launch_bwd<T, 256, 128, false, false>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct WgradParams {
  const void* z;   // [M][rp]
  const void* a;   // rows [0, ncut) of the first product's right operand, [.][rp]
  const void* x;   // its rows [ncut, N)
  const void* s;   // [M][rp] left operand of the second product, or null
  const void* pa;  // rows [0, ncut) of the second product's right operand
  const void* tx;  // its rows [ncut, N)
  int M, N, ncut, rp, ksplit;
  float* out;      // [splits][M][N] partial sums, one per split of the samples
};

// Rows [r0, r0 + kTile) of a feature-major operand, columns [k0, k0 + kKS),
// into dst [kTile][kKS + PAD]. Row r comes from a (r < ncut) or from x (row
// r - ncut); rows at or past nrows are zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* a, const T* x, int ncut, int nrows,
                                          int r0, size_t rp, size_t k0) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = kKS / EPC;
  constexpr int LD = kKS + Pad<T>::v;
  for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
    const int row = i / CPR, c = i % CPR, r = r0 + row;
    T* d = dst + row * LD + c * EPC;
    if (r < nrows) {
      const T* src = (r < ncut ? a + static_cast<size_t>(r) * rp
                               : x + static_cast<size_t>(r - ncut) * rp) + k0 + c * EPC;
      cp_async16(d, src);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One [kTile][kTile] tile of one split's partial weight gradient. The
// samples are the contraction index, contiguous in both operands, which is
// the mma row.col order; two stages of cp.async overlap loads and products.
template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = kKS + Pad<T>::v;
  constexpr int TILE = kTile * LD;
  T* buf = reinterpret_cast<T*>(smem);  // [2 stages][z | a | s | pa][kTile][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const size_t rp = static_cast<size_t>(p.rp);
  const size_t kb = static_cast<size_t>(blockIdx.z) * p.ksplit;
  const size_t ke = kb + p.ksplit < rp ? kb + p.ksplit : rp;
  const int ns = static_cast<int>((ke - kb) / kKS);
  const bool two = p.s != nullptr;
  const T* z = static_cast<const T*>(p.z);
  const T* a = static_cast<const T*>(p.a);
  const T* x = static_cast<const T*>(p.x);
  const T* s = static_cast<const T*>(p.s);
  const T* pa = static_cast<const T*>(p.pa);
  const T* tx = static_cast<const T*>(p.tx);

  float acc[2][2][kTile / 32][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kTile / 32; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[h][mt][nt][i] = 0.f;

  auto stage = [&](int step, int slot) {
    T* b = buf + slot * 4 * TILE;
    const size_t k0 = kb + static_cast<size_t>(step) * kKS;
    load_rows<T>(b, z, z, p.M, p.M, m0, rp, k0);
    load_rows<T>(b + TILE, a, x, p.ncut, p.N, n0, rp, k0);
    if (two) {
      load_rows<T>(b + 2 * TILE, s, s, p.M, p.M, m0, rp, k0);
      load_rows<T>(b + 3 * TILE, pa, tx, p.ncut, p.N, n0, rp, k0);
    }
    cp_async_commit();
  };
  stage(0, 0);
  for (int step = 0; step < ns; ++step) {
    if (step + 1 < ns) {
      stage(step + 1, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* b = buf + (step & 1) * 4 * TILE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mma_slice<kTile>(acc[h], b + h * 64 * LD, LD, 0, b + TILE, wm, wn, lane);
      if (two) mma_slice<kTile>(acc[h], b + 2 * TILE + h * 64 * LD, LD, 0, b + 3 * TILE, wm, wn, lane);
    }
    __syncthreads();
  }

  float* out = p.out + static_cast<size_t>(blockIdx.z) * p.M * p.N;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kTile / 32; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + h * 64 + wm * 32 + mt * 16 + g + 8 * (i >> 1);
          const int col = n0 + wn * (kTile / 4) + nt * 8 + 2 * t + (i & 1);
          if (row < p.M && col < p.N) out[static_cast<size_t>(row) * p.N + col] = acc[h][mt][nt][i];
        }
}

template <typename T>
int launch_wgrad(const WgradParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * 4 * kTile * (kKS + Pad<T>::v);
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.N + kTile - 1) / kTile, (p.M + kTile - 1) / kTile,
                  (p.rp + p.ksplit - 1) / p.ksplit);
  wgrad_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dst[r][c] (= dst[r][c] when accumulating, else 0) + sum over s in order of
// parts[s][r][c], for c < k_out of each part's k columns.
__global__ void reduce_kernel(const float* parts, int nparts, int rows, int k, int k_out,
                              float* dst, int accumulate) {
  const size_t total = static_cast<size_t>(rows) * k_out;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / k_out, c = i % k_out;
    float s = accumulate ? dst[i] : 0.f;
    for (int q = 0; q < nparts; ++q) s += parts[(static_cast<size_t>(q) * rows + r) * k + c];
    dst[i] = s;
  }
}

}  // namespace

// Plain C entries for ctypes. dtype: 0 = float32, 1 = bfloat16. Each returns
// the cudaError_t of its launch (0 on success), allocates nothing and does
// not synchronise; all run on `stream`.

// The per-tile backward over one slab of n samples (K4 with ubar, K5 with dx).
// With ide_p > 0 (K8; K9 with geo) the columns between x0 and x1 are the
// IDE of g and k as in refnerf_trunk_fwd, and d g, d k go to ddg [n][3] and
// ddk [n] (needs dx); with rgb_bar non-null (K10) the cotangent of the final
// rgb adds to the rgb head's, and d rawd, d rawt go to drawd, drawt [n][3].
// With lm non-null (K7) x0 and x1 are null and the segments are the IPE of
// lm, lv [n][nb] with the scales of fold, as in refnerf_trunk_fwd; with wbar
// non-null (K6) the cotangent of the weights of rays of `samples` rows (from
// the forward's raw density sig [n], delta [n] and bsig [1]) adds to sbar's,
// and d bsig is the last entry of the vector row (nvec one longer). With
// ybar non-null (K11; width 256, hc 0, no ubar, no fused stage) the
// cotangent of y [n][width] in the compute dtype joins y's.
extern "C" int refnerf_trunk_bwd(int dtype, int width, int hc, const void* x0, int d0,
                                 const void* x1, int d1, int n, int kin, int depth, int skip,
                                 const void* w, const void* wt, const void* b, const float* wd,
                                 const float* wh, const float* bh, int hf, const void* wct,
                                 const float* sbar, const float* hbar, const void* cbar,
                                 const float* ubar, const float* fold, int nb, void* dx0,
                                 void* dx1, float* dxs, int rp, void* hs, void* zs, void* ss,
                                 void* ps, void* xs, void* ts, void* cs, float* vec, int nvec,
                                 const float* g, const float* v, const float* k, int ide_p,
                                 int lmax, int geo, const float* mat, const float* sg,
                                 const float* gm, float* ddg, float* ddk, const float* rawd,
                                 const float* rawt, const float* rgb_bar, float* drawd,
                                 float* drawt, float premult, float rbias, float pad,
                                 const float* lm, const float* lv, const float* delta,
                                 const float* bsig, const float* sig, const float* wbar,
                                 int samples, const void* ybar, void* stream) {
  const DirIn dir{g, v, k, mat, sg, gm, ide_p, lmax, geo ? 1 : 0};
  const int esize = dtype == 1 ? 2 : 4;
  if (n <= 0 || rp < n || rp % kRows != 0 || kin % kKS != 0 || d0 + dir.width() + d1 > kin ||
      depth > 16 || depth < 1 || skip >= depth || (hf > 0 && wh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // K8 needs dx, and its f32 cotangents must fit in the input tile.
  if (ide_p != 0 &&
      (ide_p < 0 || lmax < 0 || lmax > 16 || g == nullptr || k == nullptr || mat == nullptr ||
       sg == nullptr || gm == nullptr || (geo && v == nullptr) || dx0 == nullptr ||
       ddg == nullptr || ddk == nullptr || ubar != nullptr ||
       4 * dir.width() > (kin + 16 / esize) * esize))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rgb_bar != nullptr && (hf != 3 || bh == nullptr || rawd == nullptr || rawt == nullptr ||
                             drawd == nullptr || drawt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ubar != nullptr && (wd == nullptr || fold == nullptr || d0 != d1 || nb <= 0 || nb > 4 ||
                          ss == nullptr || ps == nullptr || ts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dx0 != nullptr && (dxs == nullptr || (d1 > 0 && dx1 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lm != nullptr && (lv == nullptr || fold == nullptr || x0 != nullptr || x1 != nullptr ||
                        d0 != d1 || nb <= 0 || d0 % nb != 0 || ide_p != 0 || dx0 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wbar != nullptr && (samples <= 0 || n % samples != 0 || wd == nullptr ||
                          delta == nullptr || bsig == nullptr || sig == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec_need = depth * width + (wd != nullptr ? width : 0) + hf * width + hf + hc +
                        (wbar != nullptr ? 1 : 0);
  if (nvec != nvec_need) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{x0, x1, d0, d1, n, kin, depth, skip, w, wt, b, wd, wh, bh, hf, wct, sbar, hbar,
              cbar, ubar, fold, nb, dx0, dx1, dxs, rp, hs, zs, ss, ps, xs, ts, cs, vec, nvec,
              dir, ddg, ddk, Rgbe{rawd, rawt, premult, rbias, pad}, rgb_bar, drawd, drawt,
              Ipe{lm, lv, fold, nb}, delta, bsig, sig, wbar, samples, ybar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_bwd<float>(width, hc, p, s);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(width, hc, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Per-split partials out[split][M][N] of dW = Z A^T (+ S B^T) over rp samples.
extern "C" int refnerf_wgrad(int dtype, int M, int N, int ncut, int rp, int ksplit,
                             const void* z, const void* a, const void* x, const void* s,
                             const void* pa, const void* tx, float* out, void* stream) {
  if (M <= 0 || N <= 0 || ncut < 0 || ncut > N || rp <= 0 || rp % kKS != 0 || ksplit <= 0 ||
      ksplit % kKS != 0 || (ncut < N && x == nullptr) || (s != nullptr && pa == nullptr && ncut > 0) ||
      (s != nullptr && tx == nullptr && ncut < N))
    return static_cast<int>(cudaErrorInvalidValue);
  WgradParams p{z, a, x, s, pa, tx, M, N, ncut, rp, ksplit, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_wgrad<float>(p, st);
  if (dtype == 1) return launch_wgrad<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dst [rows][k_out] (+)= the fixed-order sum of nparts partials [rows][k].
extern "C" int refnerf_reduce(const float* parts, int nparts, int rows, int k, int k_out,
                              float* dst, int accumulate, void* stream) {
  if (nparts <= 0 || rows <= 0 || k_out <= 0 || k_out > k)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(rows) * k_out;
  const int threads = 256;
  const int blocks = static_cast<int>(total / threads + 1 < 4096 ? total / threads + 1 : 4096);
  reduce_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      parts, nparts, rows, k, k_out, dst, accumulate);
  return static_cast<int>(cudaGetLastError());
}

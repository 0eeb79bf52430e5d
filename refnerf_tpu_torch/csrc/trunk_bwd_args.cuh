// The per-tile backward's parameters and the checks of its C entries
// (refnerf_trunk_bwd in trunk_bwd.cu, refnerf_trunk_bwd_tma in
// trunk_bwd_tma.cu), which take the same arguments.

#pragma once

#include "phase_stamps.cuh"
#include "trunk_common.cuh"

namespace {

// The density gradient's basis vectors (nb, the fold's columns): at most 4
// on up to 256 input columns, at most kMaxNbWide past them (the wide-input
// instances; the MLP's default icosahedron basis has 21).
constexpr int kMaxNbWide = 32;

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
  // The weight-gradient operands, feature-major as below in trunk_bwd.cu,
  // sample-major ([depth][rp][W], [rp][kin], [rp][HC]) in trunk_bwd_tma.cu.
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

// The argument list of the per-tile backward's C entries, and its names.
#define REFNERF_BWD_ARGS                                                          \
  int dtype, int width, int hc, const void *x0, int d0, const void *x1, int d1, int n,   \
      int kin, int depth, int skip, const void *w, const void *wt, const void *b,       \
      const float *wd, const float *wh, const float *bh, int hf, const void *wct,       \
      const float *sbar, const float *hbar, const void *cbar, const float *ubar,        \
      const float *fold, int nb, void *dx0, void *dx1, float *dxs, int rp, void *hs,    \
      void *zs, void *ss, void *ps, void *xs, void *ts, void *cs, float *vec, int nvec, \
      const float *g, const float *v, const float *k, int ide_p, int lmax, int geo,     \
      const float *mat, const float *sg, const float *gm, float *ddg, float *ddk,       \
      const float *rawd, const float *rawt, const float *rgb_bar, float *drawd,         \
      float *drawt, float premult, float rbias, float pad, const float *lm,             \
      const float *lv, const float *delta, const float *bsig, const float *sig,         \
      const float *wbar, int samples, const void *ybar, void *stream
#define REFNERF_BWD_NAMES                                                          \
  dtype, width, hc, x0, d0, x1, d1, n, kin, depth, skip, w, wt, b, wd, wh, bh, hf, wct, \
      sbar, hbar, cbar, ubar, fold, nb, dx0, dx1, dxs, rp, hs, zs, ss, ps, xs, ts, cs,  \
      vec, nvec, g, v, k, ide_p, lmax, geo, mat, sg, gm, ddg, ddk, rawd, rawt, rgb_bar, \
      drawd, drawt, premult, rbias, pad, lm, lv, delta, bsig, sig, wbar, samples, ybar, \
      stream

// Checks the arguments against each other and fills p; returns the
// cudaError_t to give back (0 when they are consistent).
inline int bwd_params(BwdParams& out, REFNERF_BWD_ARGS) {
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
  if (ubar != nullptr &&
      (wd == nullptr || fold == nullptr || d0 != d1 || nb <= 0 ||
       nb > (kin > 256 ? kMaxNbWide : 4) || ss == nullptr || ps == nullptr || ts == nullptr))
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
  out = BwdParams{x0, x1, d0, d1, n, kin, depth, skip, w, wt, b, wd, wh, bh, hf, wct, sbar, hbar,
              cbar, ubar, fold, nb, dx0, dx1, dxs, rp, hs, zs, ss, ps, xs, ts, cs, vec, nvec,
              dir, ddg, ddk, Rgbe{rawd, rawt, premult, rbias, pad}, rgb_bar, drawd, drawt,
              Ipe{lm, lv, fold, nb}, delta, bsig, sig, wbar, samples, ybar};
  (void)dtype, (void)width, (void)stream;
  return 0;
}

}  // namespace

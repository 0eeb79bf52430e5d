// The trunk forward's parameters and the checks of its C entries
// (refnerf_trunk_fwd in trunk_fwd.cu, refnerf_trunk_fwd_tma in
// trunk_fwd_tma.cu), which take the same arguments.

#pragma once

#include "phase_stamps.cuh"
#include "trunk_common.cuh"

namespace {

// The density gradient's basis vectors (nb, the fold's columns): at most 4
// on up to 256 input columns, at most kMaxNbWide past them (the wide-input
// instances; the MLP's default icosahedron basis has 21).
constexpr int kMaxNbWide = 32;

struct FwdParams {
  const void* x0;   // [n][d0] segment 0, compute dtype
  const void* x1;   // [n][d1] the last segment (d1 may be 0)
  int d0, d1, n;
  int kin;          // d0 + dir.width() + d1 rounded up to kKS
  int depth, skip;  // skip: index of the layer fed [act | segments], or -1
  const void* w;    // per layer [W][K_l] (K_l = kin | W | W + kin), concatenated
  const void* b;    // [depth][W] compute dtype
  const float* wd;  // [W] density head, or null
  const float* wh;  // [hf][W] f32 head block, or null
  const float* bh;  // [hf]
  int hf;
  const void* wc;   // [HC][W] compute-dtype head
  const void* bc;   // [HC]
  const float* fold;  // [d0][nb] scale fold S (K3), or null
  int nb;
  float* sig;       // [n] out
  float* hout;      // [n][hf] out
  void* cout;       // [n][HC] out, compute dtype
  float* u;         // [n][nb] out (K3), or null
  const void* wt;   // per layer [K_l][W] (W_l transposed), concatenated
  DirIn dir;        // K8/K9: the IDE block between x0 and x1 (dir.p > 0)
  Rgbe rgbe;        // K10, with rgb non-null
  float* rgb;       // [n][3] out: the final rgb (K10), or null
  Ipe ipe;          // K7 with ipe.lm non-null: (lm, lv) in place of x0, x1
  const float* delta;  // [n] K6: t-interval x |direction|
  const float* bsig;   // [1] K6: the density head's bias + the activation's
  int samples;      // K6: samples a ray (consecutive rows)
  int tiles;        // tiles a CTA runs: lcm(samples, kRows) / kRows with K6, else 1
  float* wts;       // [n] out: the compositing weights (K6), or null
  void* y;          // [n][W] out, compute dtype: the last activation (K11)
};

// The argument list of the forward's C entries, and its names.
#define REFNERF_FWD_ARGS                                                                \
  int dtype, int width, int hc, const void *x0, int d0, const void *x1, int d1, int n,  \
      int kin, int depth, int skip, const void *w, const void *wt, const void *b,      \
      const float *wd, const float *wh, const float *bh, int hf, const void *wc,       \
      const void *bc, const float *fold, int nb, float *sig, float *hout, void *cout,  \
      float *u, const float *g, const float *v, const float *k, int ide_p, int lmax,   \
      int geo, const float *mat, const float *sg, const float *gm, const float *rawd,  \
      const float *rawt, float *rgb, float premult, float rbias, float pad,            \
      const float *lm, const float *lv, const float *delta, const float *bsig,         \
      int samples, float *wts, void *y, void *stream
#define REFNERF_FWD_NAMES                                                             \
  dtype, width, hc, x0, d0, x1, d1, n, kin, depth, skip, w, wt, b, wd, wh, bh, hf, wc, \
      bc, fold, nb, sig, hout, cout, u, g, v, k, ide_p, lmax, geo, mat, sg, gm, rawd,  \
      rawt, rgb, premult, rbias, pad, lm, lv, delta, bsig, samples, wts, y, stream

// Checks the arguments against each other and fills p; returns the
// cudaError_t to give back (0 when they are consistent). With K6 a CTA owns
// lcm(samples, kRows) rows, whole tiles holding whole rays.
inline int fwd_params(FwdParams& out, REFNERF_FWD_ARGS) {
  const DirIn dir{g, v, k, mat, sg, gm, ide_p, lmax, geo ? 1 : 0};
  if (n <= 0 || kin % kKS != 0 || d0 + dir.width() + d1 > kin || depth > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (u != nullptr && (wd == nullptr || wt == nullptr || fold == nullptr || d0 != d1 ||
                       nb <= 0 || nb > (kin > 256 ? kMaxNbWide : 4) || ide_p != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ide_p != 0 && (ide_p < 0 || lmax < 0 || lmax > 16 || g == nullptr || k == nullptr ||
                     mat == nullptr || sg == nullptr || gm == nullptr || (geo && v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rgb != nullptr && (hf != 3 || hout == nullptr || rawd == nullptr || rawt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lm != nullptr && (lv == nullptr || fold == nullptr || x0 != nullptr || x1 != nullptr ||
                        d0 != d1 || nb <= 0 || d0 % nb != 0 || ide_p != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 1;
  if (wts != nullptr) {
    if (samples <= 0 || n % samples != 0 || wd == nullptr || delta == nullptr ||
        bsig == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    int a = samples, r = kRows;  // tiles = lcm(samples, kRows) / kRows
    while (r != 0) {
      const int q = a % r;
      a = r;
      r = q;
    }
    tiles = samples / a;
    if (tiles * kRows > 1024) return static_cast<int>(cudaErrorInvalidValue);
  }
  out = FwdParams{x0, x1, d0, d1, n, kin, depth, skip, w, b, wd, wh, bh, hf, wc, bc,
                  fold, nb, sig, hout, cout, u, wt, dir, Rgbe{rawd, rawt, premult, rbias, pad},
                  rgb, Ipe{lm, lv, fold, nb}, delta, bsig, samples, tiles, wts, y};
  (void)dtype, (void)width, (void)hc, (void)stream;
  return 0;
}

}  // namespace

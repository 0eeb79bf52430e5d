// Layer-fused dense trunk forward for Hopper (sm_90a).
//
// Replaces the forward Pallas kernel `_fwd_kernel` of
// refnerf_tpu/ops/pallas/fused_mlp.py in these modes:
//   K1  spatial trunk (`fused_encoded_trunk`): segments (xs, xc), density
//       head, f32 head block, compute-dtype bottleneck head;
//   K2  directional trunk (`fused_trunk`): segments (bottleneck, IDE + n.v),
//       f32 rgb head;
//   K3  K1 with `density_grad` (`_inner_chain` :589-609, :651-665): the
//       density gradient folded onto the lifted means, u [n, nb];
//   K8  K2 with `ide` (`_segments` :531-547, `_ide_fwd` :402): the IDE made
//       in the CTA from refdirs and kappa_inv (7 f32 a sample in instead of
//       the 73-wide encoding), written into the input tile;
//   K9  K8 with `ide_geo` (`_dir_geometry` :355): refdirs and n.v from
//       grad_pred and viewdirs;
//   K10 K2 with `rgbe` (:646-647, `_rgb_epilogue` :283): the colour epilogue
//       after the rgb head, the final rgb stored beside the raw rgb;
//   K7  K1/K3 with `encode` (`_segments` :550-563, `_safe_trig_arg` :191):
//       the IPE made in the CTA from the lifted means and variances (24 B a
//       sample in instead of the 96-column encoding); K3's fold takes the
//       f32 e cos m and e sin m (:657-659);
//   K6  K1/K3 with `weights` (`_epilogue_fwd` :498): the compositing
//       weights of whole rays after the density head;
//   K11 K1 with `out_y` (:617, :629-630): the trunk's last activation y
//       [n, W] stored in the compute dtype beside sigma (mip-NeRF without
//       view directions, whose rgb head reads y outside the kernel).
// K8-K10 (trunk_common.cuh) run in the directional instance with DIR set,
// K6 and K7 in the spatial instance with SPA set, K11 in the instance with
// YO set; every other instance is built without their code. The
// directional trunk runs at width 256 (Ref-NeRF) and 128 (mip-NeRF, segments
// (128, 33)); every width-dependent shape below is written in W: the ring
// 2 x [max(W, HC)][kKS + PAD], the 2 x 4 warp layout with W / 32 n-tiles of
// 8 a warp, and the f32 heads' W / 32 values a lane.
//
// What it computes (fused_mlp.py `_forward_trunk`, `_fwd_kernel`):
//   h_0 = relu(cdt(x @ W0) + cdt(b0)),  x = [seg0 | seg1] read in place
//   h_l = relu(cdt(h_{l-1} @ Wa_l [+ x @ Wb_l at the skip layer]) + cdt(b_l))
//   sigma = f32(y) . wd                      (bias added by the caller)
//   hf    = f32(y) @ wh + bh                 (f32 heads)
//   hc    = cdt(y @ wc) + cdt(bc)            (compute-dtype head)
// and with the density gradient the reverse chain
//   q = cdt(wd);  s_l = relu'(h_l) q;  q = cdt(s_l Wa_l)  (l = L-1 .. 1)
//   u_x = sum over the input-consuming layers of s_l Wx_l   (f32)
//   u_m = f32(xc) u_xs - f32(xs) u_xc;  u = u_m @ S  (S the scale fold)
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
// to a multiple of kKS), which is exactly the mma B-fragment order; the
// reverse chain reads the transposed copy [K][out] the same way. For K3 the
// relu' masks of all layers stay in shared memory as bits (2 KB per layer)
// and the segment gradients as an f32 [kRows][kin] tile.
//
// K6 needs a ray's S samples in one CTA, and a ray may be longer than the
// 64-row tile (S = 128 on the flagship). So with K6 a CTA owns the smallest
// run of whole tiles that holds whole rays (lcm(S, 64) rows, at most 1,024),
// runs the trunk over its tiles in turn, keeps each row's raw density in
// shared memory, and then scans each ray with one warp. The weights never
// need a second kernel or a round trip of sigma through device memory.
//
// Bound on the H100: at N = 524,288 samples a flagship trunk is ~0.57 TFLOP
// per pass (K3 runs two), and the only device-memory traffic is the segments
// in and the heads out (~0.2-0.26 GB; the weights stay in L2), about 2,000
// FLOP per byte, so the kernel is bound by the tensor-core (bf16) or FMA
// (f32) throughput. This first version uses mma.sync m16n8k16 (bf16) and
// plain FMA (f32); wgmma/TMA and a deeper pipeline are later work. K11's y
// (512 B a sample in bf16, 268 MB at that N, 0.08 ms at 3.35 TB/s) stays
// under the 0.54 ms of its trunk's tensor work. The width-128 directional
// trunk is ~0.31 MFLOP a sample (kin 161 padded to 192 is the kernel's own
// cost), in the same tiles with half the accumulators a thread.

#include "trunk_common.cuh"

namespace {

struct Params {
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

// K11: the resident activation tile to y [n][W], 16 bytes a thread and
// consecutive threads on consecutive addresses; rows past n are skipped.
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* y, const T* act, int lda, int row0, int n) {
  constexpr int EPC = 16 / sizeof(T), CPR = W / EPC;  // elements, copies a row
  for (int i = threadIdx.x; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * EPC, gr = row0 + r;
    if (gr < n)
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(gr) * W + c) =
          *reinterpret_cast<const uint4*>(act + r * lda + c);
  }
}

// K3: the density-gradient reverse chain on the resident tile, then the
// fold of the segment gradients onto the lifted means (fused_mlp.py
// :589-609, :651-662). Runs after the heads; overwrites the activation tile.
template <typename T, int W, bool SPA>
__device__ void inner_chain(const Params& p, T* act, int lda, const T* inb, int ldi, T* ring,
                            const uint32_t* bits, float* uacc, int row0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  __syncthreads();  // every head has read y
  for (int i = tid; i < kRows * W; i += kThreads)
    act[(i / W) * lda + i % W] = from_f<T>(p.wd[i % W]);
  for (int i = tid; i < kRows * p.kin; i += kThreads) uacc[i] = 0.f;
  // Offsets of each layer's transposed block.
  const T* wt = static_cast<const T*>(p.wt);
  size_t off[16];
  size_t o = 0;
  for (int l = 0; l < p.depth; ++l) {
    off[l] = o;
    o += static_cast<size_t>(W) * (l == 0 ? p.kin : (l == p.skip ? W + p.kin : W));
  }
  __syncthreads();
  for (int l = p.depth - 1; l >= 0; --l) {
    const uint32_t* bl = bits + l * kRows * (W / 32);
    for (int i = tid; i < kRows * W; i += kThreads) {
      const int r = i / W, c = i % W;
      if (!mask_at<W>(bl, r, c)) act[r * lda + c] = from_f<T>(0.f);
    }
    __syncthreads();
    if (l == 0 || l == p.skip) {
      const int base = l == 0 ? 0 : W;
      for (int c0 = 0; c0 < p.kin; c0 += 32) {
        float acc[2][1][4];
        gemm<T, 32>(acc, act, lda, W, act, lda, wt + off[l] + static_cast<size_t>(base + c0) * W,
                    W, ring);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mt * 16 + g + 8 * h, col = c0 + wn * 8 + 2 * t;
            uacc[r * p.kin + col] += acc[mt][0][2 * h];
            uacc[r * p.kin + col + 1] += acc[mt][0][2 * h + 1];
          }
      }
    }
    if (l > 0) {
      float acc[2][W / 32][4];
      gemm<T, W>(acc, act, lda, W, act, lda, wt + off[l], W, ring);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < W / 32; ++nt) {
          const int col = wn * (W / 4) + nt * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mt * 16 + g + 8 * h;
            store2<T>(act + r * lda + col, round_t<T>(acc[mt][nt][2 * h]),
                      round_t<T>(acc[mt][nt][2 * h + 1]));
          }
        }
      __syncthreads();
    }
  }
  __syncthreads();
  const int F = p.d0;
  if constexpr (SPA) {
    if (p.ipe.lm != nullptr) {
      // K7: u_m = e (cos m u_xs - sin m u_xc) in f32 (:657-659), in place of
      // u_xs, then the fold.
      for (int i = tid; i < kRows * F; i += kThreads) {
        const int r = i / F, c = i % F, gr = row0 + r;
        if (gr >= p.n) continue;
        float e, sn, cs;
        ipe_trig(p.ipe, gr, c, e, sn, cs);
        float* ux = uacc + r * p.kin + c;
        *ux = mul(e, sub(mul(cs, ux[0]), mul(sn, ux[F])));
      }
      __syncthreads();
      for (int i = tid; i < kRows * p.nb; i += kThreads) {
        const int r = i / p.nb, j = i % p.nb, gr = row0 + r;
        if (gr >= p.n) continue;
        float s = 0.f;
        for (int c = 0; c < F; ++c) s = fmaf(uacc[r * p.kin + c], p.fold[c * p.nb + j], s);
        p.u[static_cast<size_t>(gr) * p.nb + j] = s;
      }
      return;
    }
  }
  for (int i = tid; i < kRows * p.nb; i += kThreads) {
    const int r = i / p.nb, j = i % p.nb, gr = row0 + r;
    if (gr >= p.n) continue;
    float s = 0.f;
    for (int c = 0; c < F; ++c) {
      const float um = to_f(inb[r * ldi + F + c]) * uacc[r * p.kin + c] -
                       to_f(inb[r * ldi + c]) * uacc[r * p.kin + F + c];
      s = fmaf(um, p.fold[c * p.nb + j], s);
    }
    p.u[static_cast<size_t>(gr) * p.nb + j] = s;
  }
}

template <typename T, int W, int HC, bool DIR, bool SPA, bool YO = false>
__global__ void __launch_bounds__(kThreads) trunk_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAD = Pad<T>::v;
  constexpr int LDA = W + PAD;
  const int ldi = p.kin + PAD;
  T* act = reinterpret_cast<T*>(smem);  // [kRows][LDA]
  T* inb = act + kRows * LDA;           // [kRows][ldi]
  T* ring = inb + kRows * ldi;          // 2 x [max(W, HC)][kKS + PAD]
  constexpr int NMAX = W > HC ? W : HC;
  // K3 only: relu' bits [depth][kRows][W / 32], segment gradients [kRows][kin].
  uint32_t* bits = reinterpret_cast<uint32_t*>(ring + 2 * NMAX * (kKS + PAD));
  float* uacc = reinterpret_cast<float*>(bits + p.depth * kRows * (W / 32));
  const bool dg = p.u != nullptr;
  // K6 only: the raw density of the CTA's rows [tiles * kRows], after the
  // K3 region when there is one.
  [[maybe_unused]] float* sraw =
      dg ? uacc + kRows * p.kin : reinterpret_cast<float*>(bits);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const T* x0 = static_cast<const T*>(p.x0);
  const T* x1 = static_cast<const T*>(p.x1);
  const T* bias = static_cast<const T*>(p.b);
  const int tiles = SPA ? p.tiles : 1;

  for (int tile = 0; tile < tiles; ++tile) {
    const int row0 = (blockIdx.x * tiles + tile) * kRows;
    if (SPA && tile > 0) __syncthreads();  // the last tile's reads are done

    // The segments, read in place from their own tensors (with K8 the IDE
    // block made here, with K7 the IPE), zero-padded to kin and past the last
    // row.
    if constexpr (SPA) {
      if (p.ipe.lm != nullptr)
        load_ipe<T>(inb, ldi, p.ipe, p.d0, p.kin, row0, p.n);
      else
        load_input<T, false>(inb, ldi, x0, p.d0, x1, p.d1, p.kin, row0, p.n, p.dir);
    } else {
      load_input<T, DIR>(inb, ldi, x0, p.d0, x1, p.d1, p.kin, row0, p.n, p.dir);
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
      if (dg) save_mask<T, W>(bits + l * kRows * (W / 32), act, LDA);
    }
    if constexpr (YO) store_rows<T, W>(static_cast<T*>(p.y), act, LDA, row0, p.n);

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
          if constexpr (SPA) {
            if (p.wts != nullptr && lane == 0) sraw[tile * kRows + r] = s;
          }
        }
        for (int j = 0; j < p.hf; ++j) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < W / 32; ++i) s = fmaf(y[i], p.wh[j * W + lane + 32 * i], s);
          s = warp_sum(s);
          if (lane == 0) p.hout[static_cast<size_t>(gr) * p.hf + j] = s + p.bh[j];
        }
        if constexpr (DIR) {
          if (p.rgb != nullptr && lane == 0) {  // K10 on the rgb head just stored
            const size_t o = static_cast<size_t>(gr) * 3;
            float out[3], unused[3];
            rgb_epilogue(p.hout + o, p.rgbe.rawd + o, p.rgbe.rawt + o, p.rgbe, out, nullptr,
                         unused, unused, unused);
#pragma unroll
            for (int c = 0; c < 3; ++c) p.rgb[o + c] = out[c];
          }
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
    if (dg) inner_chain<T, W, SPA>(p, act, LDA, inb, ldi, ring, bits, uacc, row0);
  }

  // K6: the weights of the CTA's rays, one warp a ray.
  if constexpr (SPA) {
    if (p.wts != nullptr) {
      __syncthreads();
      const int base = blockIdx.x * tiles * kRows, S = p.samples;
      const float bsig = __ldg(p.bsig);
      for (int q = warp; q < tiles * kRows / S; q += kThreads / 32) {
        const int r0 = base + q * S;
        if (r0 >= p.n) break;
        ray_weights(sraw + q * S, p.delta + r0, bsig, S, p.wts + r0, nullptr, nullptr);
      }
    }
  }
}

template <typename T, int W, int HC, bool DIR, bool SPA, bool YO = false>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int PAD = Pad<T>::v;
  constexpr int NMAX = W > HC ? W : HC;
  size_t smem = sizeof(T) * (static_cast<size_t>(kRows) * (W + PAD) +
                             static_cast<size_t>(kRows) * (p.kin + PAD) +
                             2 * static_cast<size_t>(NMAX) * (kKS + PAD));
  if (p.u != nullptr)
    smem += 4 * (static_cast<size_t>(p.depth) * kRows * (W / 32) +
                 static_cast<size_t>(kRows) * p.kin);
  if (SPA && p.wts != nullptr) smem += 4 * static_cast<size_t>(p.tiles) * kRows;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(trunk_fwd_kernel<T, W, HC, DIR, SPA, YO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (SPA ? p.tiles : 1) * kRows;
  const int grid = (p.n + rows - 1) / rows;
  trunk_fwd_kernel<T, W, HC, DIR, SPA, YO><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K8-K10 run on the directional trunk only (no compute-dtype head), K6 and
// K7 on the spatial trunk with its bottleneck head, K11 on the spatial
// trunk without it and without the density gradient; width 128 is the
// plain directional trunk (K2) alone: no density head, density gradient,
// compute-dtype head or fused stage, which were never checked there.
template <typename T>
int dispatch(int width, int hc, const Params& p, cudaStream_t stream) {
  const bool dir = p.dir.p != 0 || p.rgb != nullptr;
  const bool spa = p.ipe.lm != nullptr || p.wts != nullptr;
  if (p.y != nullptr)
    return width == 256 && hc == 0 && !dir && !spa && p.u == nullptr
               ? launch<T, 256, 0, false, false, true>(p, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  if (width == 128)
    return hc == 0 && !dir && !spa && p.u == nullptr && p.wd == nullptr
               ? launch<T, 128, 0, false, false>(p, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  if (width == 256 && hc == 0 && !spa)
    return dir ? launch<T, 256, 0, true, false>(p, stream)
               : launch<T, 256, 0, false, false>(p, stream);
  if (width == 256 && hc == 128 && !dir)
    return spa ? launch<T, 256, 128, false, true>(p, stream)
               : launch<T, 256, 128, false, false>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 on success). Allocates nothing and does not
// synchronise; runs on `stream`. With u non-null (K3) the density gradient
// is folded through fold [d0][nb] and written to u [n][nb].
// With ide_p > 0 (K8; K9 with geo) the columns between x0 and x1 are the
// IDE of g (refdirs, or grad_pred with viewdirs v) and kappa_inv k through
// the tables mat, sg, gm; with rgb non-null (K10) the colour epilogue of the
// rgb head (hf = 3) and rawd, rawt goes to rgb [n][3].
// With lm non-null (K7) x0 and x1 are null and the two segments (d0 = d1
// columns each) are the IPE of lm, lv [n][nb] with the scales of fold; with
// wts non-null (K6) the compositing weights of rays of `samples` rows, from
// delta [n] and bsig [1], go to wts [n]. With y non-null (K11; width 256,
// hc 0, no u, no fused stage) the last activation goes to y [n][width] in
// the compute dtype.
extern "C" int refnerf_trunk_fwd(int dtype, int width, int hc, const void* x0, int d0,
                                 const void* x1, int d1, int n, int kin, int depth, int skip,
                                 const void* w, const void* wt, const void* b, const float* wd,
                                 const float* wh, const float* bh, int hf, const void* wc,
                                 const void* bc, const float* fold, int nb, float* sig,
                                 float* hout, void* cout, float* u, const float* g,
                                 const float* v, const float* k, int ide_p, int lmax, int geo,
                                 const float* mat, const float* sg, const float* gm,
                                 const float* rawd, const float* rawt, float* rgb, float premult,
                                 float rbias, float pad, const float* lm, const float* lv,
                                 const float* delta, const float* bsig, int samples, float* wts,
                                 void* y, void* stream) {
  const DirIn dir{g, v, k, mat, sg, gm, ide_p, lmax, geo ? 1 : 0};
  if (n <= 0 || kin % kKS != 0 || d0 + dir.width() + d1 > kin || depth > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (u != nullptr && (wd == nullptr || wt == nullptr || fold == nullptr || d0 != d1 ||
                       nb <= 0 || nb > 4 || ide_p != 0))
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
  Params p{x0, x1, d0, d1, n, kin, depth, skip, w, b, wd, wh, bh, hf, wc, bc,
           fold, nb, sig, hout, cout, u, wt, dir, Rgbe{rawd, rawt, premult, rbias, pad}, rgb,
           Ipe{lm, lv, fold, nb}, delta, bsig, samples, tiles, wts, y};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(width, hc, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(width, hc, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Lets the wrapper refuse shapes before launching.
extern "C" int refnerf_trunk_supports(int width, int hc) {
  return (width == 256 && (hc == 0 || hc == 128)) || (width == 128 && hc == 0);
}

// Fused integer-factor bilinear upsample + argmax / max-softmax.
//
// Replaces: cmda_tpu/ops/pallas_ce.py::fused_resize_argmax (kernel body
// _argmax_kernel). For stride-4 logits x [B,h,w,C] (NHWC) and integer factors
// fh = H/h, fw = W/w it writes, per output pixel (b, y, x):
//   label[b,y,x] = argmax_c z_c   (ties go to the first class, like jnp.argmax)
//   prob[b,y,x]  = max_c softmax(z)_c = 1 / sum_c exp(z_c - max_c z_c)
// where z = the align_corners=False (half-pixel) bilinear upsample of x. The
// upsampled [B,H,W,C] logits are never written to device memory. prob is
// optional: serving and the step's stream accuracies ask for labels only.
//
// Math of the upsample (phase_tile.cuh): fine row y = fh*i + p is a two-tap
// blend of coarse rows i and clamp(i + step_p) with the fixed weights of
// phase p; columns likewise. The row blend is taken first, then the column
// blend, as in the TPU kernel.
//
// Bound on the H100: device memory. Without prob, at the serving shape
// [8,110,160,19] -> [8,440,640], it reads the coarse logits once (10.7 MB)
// and writes 9.0 MB of labels: ~5.9 us at 3.35 TB/s. The operations the
// function needs per (fine pixel, class), a 3-flop column blend, the row
// blend shared by the fw pixels of a coarse column and a compare (~5), take
// about as long at the fp32 rate; the exp sum of the prob adds 3.
//
// Design: a block owns ti x tj coarse pixels of one image (4 x 32 at factor 4:
// 16 x 128 fine pixels, 57 KB of shared memory). It stages coarse rows i0-1 ..
// i0+ti and columns j0-1 .. j0+tj with every class in shared memory
// (phase_tile.cuh: the halo written as clamped copies, float32 by cp.async
// with the whole tile in flight, bfloat16 through registers), so each coarse
// logit leaves device memory about once and the block waits on it once. It
// takes each fine row's row blend once, in float4, into shared memory. A fine
// pixel's z_c is then two shared-memory words of its blended row (different
// coarse columns of one class fall in different banks: the class stride is
// odd). At the repository's C = 19 and factor 4 a thread takes the 4 fine
// pixels of one coarse column in one fine row: 3 words per class serve all 4,
// the class loop is unrolled with the 4 running maxima as independent chains,
// and the 4 labels go out as one 16-byte store. Any other C or factor takes
// one thread per fine pixel. The max/argmax uses a strict > so that the first
// maximum wins; the exp2 sum runs only when prob is asked for, re-reading the
// blend. Consecutive threads take consecutive fine columns, so the stores
// coalesce. What the old design (one thread per output pixel) paid for was up
// to 9 scattered global loads per (pixel, class), the row blend rebuilt by
// each of the fh*fw pixels that share it, and the whole blend again for the
// prob. What is left above the bound is instruction issue (~6 per (pixel,
// class) at 2.25M pixels x 19 classes is ~9 us of the card's issue rate) and
// each block's wait on its tile.
//
// Any integer factors (1 included), any h, w (the last tile of a row or
// column is cut at the image's edge), any B and any C >= 1 (the tile shrinks
// until its shared memory fits; above 48 KB the kernel is given the dynamic
// shared-memory attribute).

#include "phase_tile.cuh"

namespace {

using phase_tile::allow_smem;
using phase_tile::class_stride;
using phase_tile::ColTap;
using phase_tile::exp2_approx;
using phase_tile::fill_phase_tab;
using phase_tile::grid_of;
using phase_tile::PhaseTab;
using phase_tile::PhaseW;
using phase_tile::phase_weights;
using phase_tile::pick_tile;
using phase_tile::row_stride;
using phase_tile::stage_coarse_tile;
using phase_tile::StridedDivmod;
using phase_tile::Tile;
using phase_tile::TileOrigin;

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: the coarse tile (ti+2) x (tj+2) x cp and the row blends
// (ti*fh) x (tj+2) x cp, in padded rows; the column taps; the row phases.
size_t argmax_smem(int ti, int tj, int C, int fh, int fw) {
  const size_t rs = row_stride(tj + 2, class_stride(C));
  return ((ti + 2) + (size_t)ti * fh) * rs * 4
         + (size_t)tj * fw * sizeof(ColTap) + (size_t)fh * sizeof(PhaseTab);
}

// argmax (first on ties) and, with kProb, 1 / sum_c exp(z_c - max) of one
// fine pixel whose logits are z_c = self * r0[c] + other * r1[c]; the prob
// pass reads the blend again.
template <bool kProb>
__device__ __forceinline__ int pixel_argmax(const float* r0, const float* r1,
                                            float self, float other, int C,
                                            float* prob) {
  int am = 0;
  float m = self * r0[0] + other * r1[0];
  for (int c = 1; c < C; ++c) {
    const float z = self * r0[c] + other * r1[c];
    if (z > m) {   // strict: the first maximum wins
      m = z;
      am = c;
    }
  }
  if constexpr (kProb) {
    const float m2 = m * kLog2e;
    float s = 0.0f;
    for (int c = 0; c < C; ++c)
      s += exp2_approx(fmaf(self * r0[c] + other * r1[c], kLog2e, -m2));
    *prob = 1.0f / s;
  }
  return am;
}

// z of a fine pixel of column phase w from its blended row's coarse columns
// left of, at and right of it
__device__ __forceinline__ float phase_z(const PhaseW& w, float l, float mid,
                                         float r) {
  return w.self * mid + (w.prev + w.next) * (w.prev > 0.0f ? l : r);
}

// The kFW fine pixels q = 0 .. kFW-1 of one coarse column in one blended
// row: z_q,c = self_q * M[c] + other_q * (step_q < 0 ? L[c] : R[c]), with
// L, M, R the blended row's coarse columns left of, at and right of the
// pixels (rm points at M). Three shared-memory reads per class serve the
// kFW pixels, and their kFW running maxima are independent chains. The
// phase weights are constants when compiled. With kProb the exp sum reads
// the three columns again.
template <int kC, int kFW, bool kProb>
__device__ __forceinline__ void group_argmax(const float* rm, int cp,
                                             int* am, float* prob) {
  PhaseW pw[kFW];
#pragma unroll
  for (int q = 0; q < kFW; ++q) pw[q] = phase_weights(q, kFW);
  float m[kFW];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float l = rm[c - cp], mid = rm[c], r = rm[c + cp];
#pragma unroll
    for (int q = 0; q < kFW; ++q) {
      const float z = phase_z(pw[q], l, mid, r);
      if (c == 0 || z > m[q]) {   // strict: the first maximum wins
        m[q] = z;
        am[q] = c;
      }
    }
  }
  if constexpr (kProb) {
    float s[kFW], m2[kFW];
#pragma unroll
    for (int q = 0; q < kFW; ++q) {
      s[q] = 0.0f;
      m2[q] = m[q] * kLog2e;
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float l = rm[c - cp], mid = rm[c], r = rm[c + cp];
#pragma unroll
      for (int q = 0; q < kFW; ++q) {
        const float z = phase_z(pw[q], l, mid, r);
        s[q] += exp2_approx(fmaf(z, kLog2e, -m2[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < kFW; ++q) prob[q] = 1.0f / s[q];
  }
}

template <typename T, int kC, int kFW, bool kProb>
__global__ void __launch_bounds__(kThreads)
argmax_tile_kernel(const T* __restrict__ x, int32_t* __restrict__ label,
                   float* __restrict__ prob, int h, int w, int C_arg, int fh,
                   int fw, int ti, int tj) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = kC > 0 ? kC : C_arg;
  const int cp = class_stride(C), xc = tj + 2, nfc = tj * fw;
  const int rsx = row_stride(xc, cp);   // floats per staged or blended row
  const TileOrigin o(h, w, ti, tj);
  float* xs = smem;
  float* rs = xs + (ti + 2) * rsx;
  ColTap* coltap = (ColTap*)(rs + ti * fh * rsx);   // per fine column
  PhaseTab* rtab = (PhaseTab*)(coltap + nfc);
  const int H = h * fh, W = w * fw;
  const int y0 = o.i0 * fh, x0 = o.j0 * fw;
  // the tile's fine rows and columns that lie inside the image
  const int nr = min(ti * fh, H - y0), nc = min(nfc, W - x0);
  fill_phase_tab(rtab, fh);
  // fine column fc = fw*lj + q reads blended columns lj+1 and lj+1+step
  if constexpr (kFW == 0) {
    for (int fc = threadIdx.x; fc < nc; fc += kThreads) {
      const int lj = fc / fw;
      const PhaseW pw = phase_weights(fc - lj * fw, fw);
      coltap[fc] = ColTap{pw.self, pw.prev + pw.next, (lj + 1) * cp,
                          (pw.prev > 0.0f ? -1 : 1) * cp};
    }
  }
  stage_coarse_tile(xs, x, o.b, h, w, C, cp, o.i0 - 1, ti + 2, o.j0 - 1, xc);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // row blends: R[fr] for fine row fr = fh*t + p of the tile, whole padded
  // rows in float4; tile row t is staged row t+1
  {
    const int n4 = rsx / 4;
    const float4* x4 = reinterpret_cast<const float4*>(xs);
    float4* r4 = reinterpret_cast<float4*>(rs);
    StridedDivmod it(threadIdx.x, kThreads, n4);   // (fine row, float4)
    for (int e = threadIdx.x; e < nr * n4; e += kThreads, it.next()) {
      const int t = it.q / fh;
      const PhaseTab ph = rtab[it.q - t * fh];
      const float4 a = x4[(t + 1) * n4 + it.r];
      const float4 b = x4[(t + 1 + ph.step) * n4 + it.r];
      r4[e] = make_float4(ph.self * a.x + ph.other * b.x,
                          ph.self * a.y + ph.other * b.y,
                          ph.self * a.z + ph.other * b.z,
                          ph.self * a.w + ph.other * b.w);
    }
  }
  __syncthreads();

  if constexpr (kFW == 4) {
    // a thread per (fine row, coarse column): its 4 fine pixels, stored as
    // one 16-byte vector (W = 4w and x0 = 4*j0, so every group is whole and
    // aligned)
    const int ncc = nc / kFW;
    StridedDivmod it(threadIdx.x, kThreads, ncc);   // (fine row, column)
    for (int e = threadIdx.x; e < nr * ncc; e += kThreads, it.next()) {
      int am[kFW];
      float p[kFW];
      group_argmax<kC, kFW, kProb>(rs + it.q * rsx + (it.r + 1) * cp, cp,
                                   am, p);
      const long long pix =
          ((long long)o.b * H + y0 + it.q) * W + x0 + it.r * kFW;
      *reinterpret_cast<int4*>(label + pix) =
          make_int4(am[0], am[1], am[2], am[3]);
      if constexpr (kProb)
        *reinterpret_cast<float4*>(prob + pix) =
            make_float4(p[0], p[1], p[2], p[3]);
    }
  } else {
    StridedDivmod it(threadIdx.x, kThreads, nc);   // (fine row, column)
    for (int e = threadIdx.x; e < nr * nc; e += kThreads, it.next()) {
      const ColTap ct = coltap[it.r];
      const float* r0 = rs + it.q * rsx + ct.off;
      float p = 0.0f;
      const int am = pixel_argmax<kProb>(r0, r0 + ct.step, ct.self,
                                         ct.other, C, &p);
      const long long pix = ((long long)o.b * H + y0 + it.q) * W + x0 + it.r;
      label[pix] = am;
      if constexpr (kProb) prob[pix] = p;
    }
  }
}

// ------------------------------------------------------------------- host

template <typename T, bool kProb>
int launch_t(const T* x, int32_t* label, float* prob, int B, int h, int w,
             int C, int fh, int fw, cudaStream_t stream) {
  const Tile t = pick_tile(argmax_smem, max(1, 16 / fh), max(1, 128 / fw),
                           h, w, C, fh, fw);
  // the main paths' 19 classes at factor 4 unroll, a thread taking 4 fine
  // pixels; any other C or factor takes the per-pixel loop
  auto kernel = C == 19 && fw == 4 ? argmax_tile_kernel<T, 19, 4, kProb>
                                   : argmax_tile_kernel<T, 0, 0, kProb>;
  int err = allow_smem(kernel, t.smem);
  if (err != 0) return err;
  kernel<<<(unsigned)grid_of(t, B, h, w), kThreads, t.smem, stream>>>(
      x, label, prob, h, w, C, fh, fw, t.ti, t.tj);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, int32_t* label, float* prob, int B, int h, int w,
           int C, int fh, int fw, cudaStream_t stream) {
  if ((long long)B * h * w == 0) return 0;
  return prob != nullptr
      ? launch_t<T, true>(x, label, prob, B, h, w, C, fh, fw, stream)
      : launch_t<T, false>(x, label, prob, B, h, w, C, fh, fw, stream);
}

}  // namespace

extern "C" {

// x: [B,h,w,C] float32, contiguous; label: [B,h*fh,w*fw] int32; prob: same
// shape float32, or null to skip it. Returns cudaGetLastError() after launch.
int cmda_fused_resize_argmax_f32(const float* x, int32_t* label, float* prob,
                                 int B, int h, int w, int C, int fh, int fw,
                                 void* stream) {
  return launch<float>(x, label, prob, B, h, w, C, fh, fw,
                       (cudaStream_t)stream);
}

int cmda_fused_resize_argmax_bf16(const void* x, int32_t* label, float* prob,
                                  int B, int h, int w, int C, int fh, int fw,
                                  void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)x, label, prob, B, h, w,
                               C, fh, fw, (cudaStream_t)stream);
}

const char* cmda_fused_resize_argmax_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Fused integer-factor bilinear upsample + softmax cross-entropy: the forward,
// the gradient of the coarse logits (dx) and the gradient of the pixel
// weights (dweight).
//
// For stride-4 logits x [B,h,w,C] (NHWC), labels [B,H,W] int32, optional
// pixel weights wt [B,H,W] float32 and integer factors fh = H/h, fw = W/w:
//   z[b,y,x,:] = the align_corners=False (half-pixel) bilinear upsample of x
//   lse        = log sum_c exp(z_c)
//   nll        = (lse - z_label) * wt, 0 where label == ignore_index
//   loss       = sum(nll) / (B*H*W)     (ignored pixels count in the mean)
// The upsampled [B,H,W,C] logits are never written to device memory, in
// either direction.
//
// Math of the upsample: output row y = fh*i + p samples coarse rows
// i-1 / i / i+1 (clamped at the edges) with the fixed two-tap weights of
// phase p, d = (p + 0.5)/fh - 0.5: w_prev = max(-d, 0), w_next = max(d, 0),
// w_self = 1 - w_prev - w_next (pallas_ce.py:_phase_weights). Columns
// likewise. The row blend is taken first, then the column blend, as in the
// TPU kernels and in fused_resize_argmax.cu.
//
// 1. Forward. Replaces cmda_tpu/ops/pallas_ce.py::_fwd_call (kernel body
//    _ce_fwd_kernel). Bound on the H100: device memory. It reads the coarse
//    logits once and the labels and weights once, and writes the per-pixel
//    lse for the backward: at the flagship shape [2,128,128,19] -> [2,512,512]
//    that is 2.5 + 2.1 + 2.1 + 2.1 MB, ~2.6 us at 3.35 TB/s; ~13 flops per
//    (pixel, class) plus an exp are ~2.2 us at the fp32 rate, so the two are
//    close. Design: one thread per fine pixel, consecutive threads on
//    consecutive x, so the label/weight/lse accesses coalesce and the fw
//    threads that share a coarse column read the same logits through L1. One
//    pass over C keeps an online max and sum-exp and picks out z_label. The
//    TPU kernel carried its sum across the sequential grid; GPU blocks run in
//    no order, so each block writes its partial sum (a shuffle tree, fixed
//    order) and a second one-block launch sums the partials in a fixed order
//    and divides by B*H*W. No float atomicAdd: the loss is bitwise the same
//    from run to run.
// 2. dx. Replaces _bwd_dx_call (kernel body _ce_bwd_kernel):
//       dx[b,i,j,c] = sum over fine (y,x) of Wr(y,i) Wc(x,j)
//                     * (exp(z_c - lse) - [label == c]) * g * wt / (B*H*W)
//    where Wr(y,i) is the weight of coarse row i in fine row y, the clamped
//    taps folded onto rows 0 and h-1 included (the TPU kernel's
//    _shift_t_prev/_shift_t_next). Bound: it reads the logits and writes dx
//    (2 x 2.5 MB) plus labels, weights and lse (6.3 MB), ~3.4 us; but each
//    output gathers ~(2f)^2 fine pixels and rebuilds each one's z_c from up
//    to 9 coarse taps, ~64 x 25 = 1600 flops per output, ~15 us at the fp32
//    rate: the operations bound it. Design: the gather form, one thread per
//    (b, i, j, c), c fastest so the dx stores and the tap loads coalesce and
//    the label/weight/lse loads of a fine pixel are one broadcast to the C
//    threads of a coarse pixel. Each output is written once by one thread:
//    no atomics, no fine [B,H,W,C] buffer. The forward's lse is read back
//    instead of recomputing each fine pixel's softmax denominator.
// 3. dweight. Replaces _bwd_dw_call (kernel body _ce_dw_kernel):
//       dwt[b,y,x] = (lse - z_label) * g / (B*H*W), 0 where ignored.
//    Bound: bytes (labels, lse, dwt and the logits, ~8.9 MB, ~2.7 us). One
//    thread per fine pixel, sharing the forward's tap code; one blend per
//    pixel, since lse comes from the forward.
//
// The upstream gradient g is read on the device from a pointer, so the
// backward never waits on the host. Simple and right first: tiling the
// coarse block through shared memory is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct PhaseW {
  float prev, self, next;
};

__device__ __forceinline__ PhaseW phase_weights(int p, int f) {
  float d = ((float)p + 0.5f) / (float)f - 0.5f;
  PhaseW w;
  w.prev = fmaxf(-d, 0.0f);
  w.next = fmaxf(d, 0.0f);
  w.self = 1.0f - w.prev - w.next;
  return w;
}

// The coarse taps of one fine pixel (b, y = fh*i + p, x = fw*j + q).
template <typename T>
struct Taps {
  const T *r_i, *r_p, *r_n;   // coarse rows i, i-1, i+1 (clamped)
  long long cj, cp, cn;       // column offsets j, j-1, j+1 (clamped) * C
  PhaseW wr, wq;

  __device__ __forceinline__ Taps(const T* x, int b, int i, int p, int j,
                                  int q, int h, int w, int C, int fh,
                                  int fw) {
    const long long rs = (long long)w * C;
    const T* base = x + (long long)b * h * rs;
    r_i = base + (long long)i * rs;
    r_p = base + (long long)max(i - 1, 0) * rs;
    r_n = base + (long long)min(i + 1, h - 1) * rs;
    cj = (long long)j * C;
    cp = (long long)max(j - 1, 0) * C;
    cn = (long long)min(j + 1, w - 1) * C;
    wr = phase_weights(p, fh);
    wq = phase_weights(q, fw);
  }

  // z_c of the fine pixel: the row blend at columns j, j-1, j+1, then the
  // column blend; column taps of weight 0 are skipped, as the TPU kernel
  // skips them statically
  __device__ __forceinline__ float z(int c) const {
    float r = wr.self * load_f(r_i + cj + c) + wr.prev * load_f(r_p + cj + c)
              + wr.next * load_f(r_n + cj + c);
    float out = wq.self * r;
    if (wq.prev != 0.0f) {
      float rp = wr.self * load_f(r_i + cp + c) + wr.prev * load_f(r_p + cp + c)
                 + wr.next * load_f(r_n + cp + c);
      out = out + wq.prev * rp;
    }
    if (wq.next != 0.0f) {
      float rn = wr.self * load_f(r_i + cn + c) + wr.prev * load_f(r_p + cn + c)
                 + wr.next * load_f(r_n + cn + c);
      out = out + wq.next * rn;
    }
    return out;
  }
};

// fine pixel index -> (b, oy, ox)
struct FinePix {
  int b, oy, ox;
  __device__ __forceinline__ FinePix(long long idx, int H, int W) {
    ox = (int)(idx % W);
    oy = (int)((idx / W) % H);
    b = (int)(idx / ((long long)W * H));
  }
};

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffff, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffff, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
              const float* __restrict__ wt, float* __restrict__ lse_out,
              float* __restrict__ partials, int B, int h, int w, int C,
              int fh, int fw, int ignore_index) {
  const int H = h * fh, W = w * fw;
  const long long total = (long long)B * H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  float nll = 0.0f;
  if (idx < total) {
    const FinePix px(idx, H, W);
    const int i = px.oy / fh, j = px.ox / fw;
    const Taps<T> t(x, px.b, i, px.oy - i * fh, j, px.ox - j * fw, h, w, C,
                    fh, fw);
    const int lbl = labels[idx];
    float m = -INFINITY, s = 0.0f, z_lbl = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float zc = t.z(c);
      if (c == lbl) z_lbl = zc;
      if (zc > m) {
        s = s * expf(m - zc) + 1.0f;
        m = zc;
      } else {
        s += expf(zc - m);
      }
    }
    const float lse = m + logf(s);
    if (lse_out != nullptr) lse_out[idx] = lse;
    if (lbl != ignore_index) {
      nll = lse - z_lbl;
      if (wt != nullptr) nll *= wt[idx];
    }
  }
  const float s = block_sum(nll);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// One block: the partials summed in a fixed order (double accumulators),
// divided by the number of fine pixels.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int n,
                    float n_total, float* __restrict__ out) {
  __shared__ double sums[kThreads];
  double s = 0.0;
  for (int k = threadIdx.x; k < n; k += kThreads) s += (double)partials[k];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) sums[threadIdx.x] += sums[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)sums[0] / n_total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dx_kernel(const float* __restrict__ g, const T* __restrict__ x,
             const int32_t* __restrict__ labels, const float* __restrict__ wt,
             const float* __restrict__ lse, T* __restrict__ dx, int B, int h,
             int w, int C, int fh, int fw, int ignore_index, float n_total) {
  const long long total = (long long)B * h * w * C;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const int j = (int)((idx / C) % w);
  const int i = (int)((idx / ((long long)C * w)) % h);
  const int b = (int)(idx / ((long long)C * w * h));
  const int H = h * fh, W = w * fw;
  const float gs = g[0] / n_total;

  float acc = 0.0f;
  for (int ii = max(i - 1, 0); ii <= min(i + 1, h - 1); ++ii) {
    for (int p = 0; p < fh; ++p) {
      const PhaseW wr = phase_weights(p, fh);
      // weight of coarse row i in fine row (ii, p), clamped taps folded in
      const float a = (ii == i ? wr.self : 0.0f)
                      + (max(ii - 1, 0) == i ? wr.prev : 0.0f)
                      + (min(ii + 1, h - 1) == i ? wr.next : 0.0f);
      if (a == 0.0f) continue;
      const int oy = ii * fh + p;
      for (int jj = max(j - 1, 0); jj <= min(j + 1, w - 1); ++jj) {
        for (int q = 0; q < fw; ++q) {
          const PhaseW wq = phase_weights(q, fw);
          const float bw = (jj == j ? wq.self : 0.0f)
                           + (max(jj - 1, 0) == j ? wq.prev : 0.0f)
                           + (min(jj + 1, w - 1) == j ? wq.next : 0.0f);
          if (bw == 0.0f) continue;
          const long long pix = ((long long)b * H + oy) * W + jj * fw + q;
          const int lbl = labels[pix];
          if (lbl == ignore_index) continue;
          const float coef = wt != nullptr ? gs * wt[pix] : gs;
          const Taps<T> t(x, b, ii, p, jj, q, h, w, C, fh, fw);
          const float dz =
              (expf(t.z(c) - lse[pix]) - (lbl == c ? 1.0f : 0.0f)) * coef;
          acc += a * bw * dz;
        }
      }
    }
  }
  store_f(dx + idx, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dweight_kernel(const float* __restrict__ g, const T* __restrict__ x,
                  const int32_t* __restrict__ labels,
                  const float* __restrict__ lse, float* __restrict__ dwt,
                  int B, int h, int w, int C, int fh, int fw,
                  int ignore_index, float n_total) {
  const int H = h * fh, W = w * fw;
  const long long total = (long long)B * H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int lbl = labels[idx];
  if (lbl == ignore_index) {
    dwt[idx] = 0.0f;
    return;
  }
  const FinePix px(idx, H, W);
  const int i = px.oy / fh, j = px.ox / fw;
  const Taps<T> t(x, px.b, i, px.oy - i * fh, j, px.ox - j * fw, h, w, C, fh,
                  fw);
  // a label outside [0, C) selects no class (z_label = 0), as in the TPU
  // kernel's one-hot select
  const float z_lbl = (lbl >= 0 && lbl < C) ? t.z(lbl) : 0.0f;
  dwt[idx] = (lse[idx] - z_lbl) * (g[0] / n_total);
}

long long blocks_for(long long n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int fwd(const T* x, const int32_t* labels, const float* wt, float* lse,
        float* partials, float* loss, int B, int h, int w, int C, int fh,
        int fw, int ignore_index, cudaStream_t stream) {
  const long long total = (long long)B * h * fh * w * fw;
  const long long nb = blocks_for(total);
  ce_fwd_kernel<T><<<(unsigned)nb, kThreads, 0, stream>>>(
      x, labels, wt, lse, partials, B, h, w, C, fh, fw, ignore_index);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partials, (int)nb,
                                                  (float)total, loss);
  return (int)cudaGetLastError();
}

template <typename T>
int dx(const float* g, const T* x, const int32_t* labels, const float* wt,
       const float* lse, T* out, int B, int h, int w, int C, int fh, int fw,
       int ignore_index, cudaStream_t stream) {
  const long long n = (long long)B * h * w * C;
  const float n_total = (float)((long long)B * h * fh * w * fw);
  ce_dx_kernel<T><<<(unsigned)blocks_for(n), kThreads, 0, stream>>>(
      g, x, labels, wt, lse, out, B, h, w, C, fh, fw, ignore_index, n_total);
  return (int)cudaGetLastError();
}

template <typename T>
int dweight(const float* g, const T* x, const int32_t* labels,
            const float* lse, float* out, int B, int h, int w, int C, int fh,
            int fw, int ignore_index, cudaStream_t stream) {
  const long long total = (long long)B * h * fh * w * fw;
  ce_dweight_kernel<T><<<(unsigned)blocks_for(total), kThreads, 0, stream>>>(
      g, x, labels, lse, out, B, h, w, C, fh, fw, ignore_index,
      (float)total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partial sums the forward writes (the size of its
// `partials` scratch buffer) for B*H*W fine pixels.
long long cmda_fused_resize_ce_num_partials(long long n_fine) {
  return blocks_for(n_fine);
}

// x: [B,h,w,C] contiguous (float32 or bfloat16); labels: [B,h*fh,w*fw]
// int32; wt: same shape float32 or null; lse: same shape float32 (written);
// partials: float32 scratch of cmda_fused_resize_ce_num_partials(B*H*W);
// loss: one float32 (written). Returns cudaGetLastError() after the launches.
int cmda_fused_resize_ce_fwd_f32(const float* x, const int32_t* labels,
                                 const float* wt, float* lse, float* partials,
                                 float* loss, int B, int h, int w, int C,
                                 int fh, int fw, int ignore_index,
                                 void* stream) {
  return fwd<float>(x, labels, wt, lse, partials, loss, B, h, w, C, fh, fw,
                    ignore_index, (cudaStream_t)stream);
}

int cmda_fused_resize_ce_fwd_bf16(const void* x, const int32_t* labels,
                                  const float* wt, float* lse,
                                  float* partials, float* loss, int B, int h,
                                  int w, int C, int fh, int fw,
                                  int ignore_index, void* stream) {
  return fwd<__nv_bfloat16>((const __nv_bfloat16*)x, labels, wt, lse,
                            partials, loss, B, h, w, C, fh, fw, ignore_index,
                            (cudaStream_t)stream);
}

// g: one float32 on the device (the loss's upstream gradient); dx: [B,h,w,C]
// in the logits' dtype (written).
int cmda_fused_resize_ce_dx_f32(const float* g, const float* x,
                                const int32_t* labels, const float* wt,
                                const float* lse, float* out, int B, int h,
                                int w, int C, int fh, int fw,
                                int ignore_index, void* stream) {
  return dx<float>(g, x, labels, wt, lse, out, B, h, w, C, fh, fw,
                   ignore_index, (cudaStream_t)stream);
}

int cmda_fused_resize_ce_dx_bf16(const float* g, const void* x,
                                 const int32_t* labels, const float* wt,
                                 const float* lse, void* out, int B, int h,
                                 int w, int C, int fh, int fw,
                                 int ignore_index, void* stream) {
  return dx<__nv_bfloat16>(g, (const __nv_bfloat16*)x, labels, wt, lse,
                           (__nv_bfloat16*)out, B, h, w, C, fh, fw,
                           ignore_index, (cudaStream_t)stream);
}

// dwt: [B,h*fh,w*fw] float32 (written).
int cmda_fused_resize_ce_dweight_f32(const float* g, const float* x,
                                     const int32_t* labels, const float* lse,
                                     float* out, int B, int h, int w, int C,
                                     int fh, int fw, int ignore_index,
                                     void* stream) {
  return dweight<float>(g, x, labels, lse, out, B, h, w, C, fh, fw,
                        ignore_index, (cudaStream_t)stream);
}

int cmda_fused_resize_ce_dweight_bf16(const float* g, const void* x,
                                      const int32_t* labels, const float* lse,
                                      float* out, int B, int h, int w, int C,
                                      int fh, int fw, int ignore_index,
                                      void* stream) {
  return dweight<__nv_bfloat16>(g, (const __nv_bfloat16*)x, labels, lse, out,
                                B, h, w, C, fh, fw, ignore_index,
                                (cudaStream_t)stream);
}

const char* cmda_fused_resize_ce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

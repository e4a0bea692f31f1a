// Fused integer-factor bilinear upsample + argmax / max-softmax.
//
// Replaces: cmda_tpu/ops/pallas_ce.py::fused_resize_argmax (kernel body
// _argmax_kernel). For stride-4 logits x [B,h,w,C] (NHWC) and integer factors
// fh = H/h, fw = W/w it writes, per output pixel (b, y, x):
//   label[b,y,x] = argmax_c z_c   (ties go to the first class, like jnp.argmax)
//   prob[b,y,x]  = max_c softmax(z)_c = 1 / sum_c exp(z_c - max_c z_c)
// where z = the align_corners=False (half-pixel) bilinear upsample of x. The
// upsampled [B,H,W,C] logits are never written to device memory.
//
// Math: output row y = fh*i + p samples coarse row i with the fixed two-tap
// weights of phase p, d = (p + 0.5)/fh - 0.5: w_prev = max(-d, 0),
// w_next = max(d, 0), w_self = 1 - w_prev - w_next, on rows i-1 / i / i+1
// clamped at the edges (pallas_ce.py:_phase_weights). Columns likewise. As in
// the TPU kernel the row blend is taken first, then the column blend.
//
// Bound on the H100: device memory. Per call it reads the coarse logits once
// (B*h*w*C*4 bytes) and writes 4 + 4 bytes per output pixel; at the serving
// shape [8,110,160,19] -> [8,440,640] that is 10.7 MB + 18.0 MB, ~8.6 us at
// 3.35 TB/s. Arithmetic is ~13 flops per (pixel, class), about the same time
// at the fp32 non-tensor-core rate, so neither side has much slack.
//
// Design: one thread per output pixel, consecutive threads on consecutive x
// so the label/prob stores coalesce. A pixel's C classes are contiguous in
// NHWC, and the fw neighbouring threads that share a coarse column read the
// same bytes, which L1 serves: each coarse logit leaves DRAM about once. Two
// passes over C (max+argmax, then the exp sum) recompute the blend instead of
// holding C values in registers, so any C works. Simple and right first;
// tiling the coarse block through shared memory is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
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

template <typename T>
__global__ void resize_argmax_kernel(const T* __restrict__ x,
                                     int32_t* __restrict__ label,
                                     float* __restrict__ prob,
                                     int B, int h, int w, int C,
                                     int fh, int fw) {
  const int H = h * fh, W = w * fw;
  const long long total = (long long)B * H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ox = (int)(idx % W);
  const int oy = (int)((idx / W) % H);
  const int b = (int)(idx / ((long long)W * H));

  const int i = oy / fh, p = oy - i * fh;
  const int j = ox / fw, q = ox - j * fw;
  const PhaseW wr = phase_weights(p, fh);
  const PhaseW wq = phase_weights(q, fw);
  const int ip = max(i - 1, 0), in = min(i + 1, h - 1);
  const int jp = max(j - 1, 0), jn = min(j + 1, w - 1);

  const long long rs = (long long)w * C;           // row stride
  const T* base = x + (long long)b * h * rs;
  const T* r_i = base + (long long)i * rs;
  const T* r_p = base + (long long)ip * rs;
  const T* r_n = base + (long long)in * rs;
  const long long cj = (long long)j * C, cp = (long long)jp * C,
                  cn = (long long)jn * C;

  // row blend at columns j, jp, jn, then the column blend; the column taps
  // whose weight is 0 are skipped, as the TPU kernel skips them statically
  auto z_at = [&](int c) -> float {
    float r = wr.self * load_f(r_i + cj + c) + wr.prev * load_f(r_p + cj + c)
              + wr.next * load_f(r_n + cj + c);
    float z = wq.self * r;
    if (wq.prev != 0.0f) {
      float rp = wr.self * load_f(r_i + cp + c) + wr.prev * load_f(r_p + cp + c)
                 + wr.next * load_f(r_n + cp + c);
      z = z + wq.prev * rp;
    }
    if (wq.next != 0.0f) {
      float rn = wr.self * load_f(r_i + cn + c) + wr.prev * load_f(r_p + cn + c)
                 + wr.next * load_f(r_n + cn + c);
      z = z + wq.next * rn;
    }
    return z;
  };

  float m = z_at(0);
  int am = 0;
  for (int c = 1; c < C; ++c) {
    float z = z_at(c);
    if (z > m) {  // strict: the first maximum wins
      m = z;
      am = c;
    }
  }
  label[idx] = am;
  if (prob != nullptr) {
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s += expf(z_at(c) - m);
    prob[idx] = 1.0f / s;
  }
}

template <typename T>
int launch(const T* x, int32_t* label, float* prob, int B, int h, int w,
           int C, int fh, int fw, cudaStream_t stream) {
  const long long total = (long long)B * h * fh * w * fw;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  resize_argmax_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, label, prob, B, h, w, C, fh, fw);
  return (int)cudaGetLastError();
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

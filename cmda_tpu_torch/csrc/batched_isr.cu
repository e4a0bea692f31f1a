// Batched Image Self-Residual (ISR), one runtime shift direction per image.
//
// Replaces: cmda_tpu/ops/pallas_kernels.py::pallas_batched_isr (kernel body
// _isr_kernel, math in _ic). Per image b of gray [B,H,W] (0..255, float32)
// with direction dir[b] in 0..3 (leftdown, leftup, rightdown, rightup;
// left = dir < 2, up = dir % 2 == 1):
//   s    = gray shifted by `shift` along the row (left/right) or the column
//          (up/down); the `shift` pixels the content left behind keep their
//          own value (the reference's concatenation trick), so d = 0 there
//   d    = log(s*k + lo) - log(g*k + lo),  k = (hi - lo) / 255
//   d    = 0 where |d| <= thr; pos = clip(max(d,0), 0, clip);
//          neg = clip(min(d,0), -clip, 0)
//   ic   = (pos - min pos)/(max pos - min pos + 1e-8)
//          + (neg - min neg)/(max neg - min neg + 1e-8) - 1
//          with min/max over the whole frame, separately for row and column
//   out  = 0.5 * ic_row + 0.5 * ic_col
//
// Bound on the H100: device memory. The function reads gray once and writes
// out once: 2 * 4 * B*H*W bytes, 18.0 MB at the serving shape [8,440,640],
// ~5.4 us at 3.35 TB/s. Arithmetic is ~30 flops and 4 logs per pixel, far
// below the byte time.
//
// Design: the TPU kernel holds a whole image in VMEM and reduces it there.
// Blocks on the GPU cannot share a frame, so this is two passes:
//   pass 1 computes d_row and d_col per pixel and reduces the 8 per-image
//          extrema (min/max of pos/neg, row and column) with a warp shuffle
//          tree, then one atomicMin/atomicMax per block on order-preserving
//          int encodings of the floats into a [B,8] scratch buffer;
//   pass 2 recomputes d (cheaper than storing it: 4 logs vs 16 bytes a pixel)
//          and writes the normalised average.
// So gray is read twice (27 MB moved, ~8.1 us); the second read mostly hits
// the 50 MB L2 at this size. logf, not __logf: the dead zone compares d with
// thr, and the fast log's error would move pixels across it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int enc(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float dec(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

struct IsrParams {
  float lo, k, thr, clip;
  int shift;
};

__device__ __forceinline__ float log_diff(float g, float s,
                                          const IsrParams& P) {
  // explicit _rn ops: no FMA contraction, so the log arguments round as the
  // reference's separate multiply and add do
  float d = logf(__fadd_rn(__fmul_rn(s, P.k), P.lo)) -
            logf(__fadd_rn(__fmul_rn(g, P.k), P.lo));
  return fabsf(d) <= P.thr ? 0.0f : d;
}

// the shifted neighbour of (y, x): row shift along x, column shift along y
__device__ __forceinline__ void diffs(const float* img, int y, int x, int H,
                                      int W, bool left, bool up,
                                      const IsrParams& P, float* d_row,
                                      float* d_col) {
  const int s = P.shift;
  const float g = img[(long long)y * W + x];
  int sx = left ? (x < W - s ? x + s : x) : (x < s ? x : x - s);
  int sy = up ? (y < H - s ? y + s : y) : (y < s ? y : y - s);
  *d_row = log_diff(g, img[(long long)y * W + sx], P);
  *d_col = log_diff(g, img[(long long)sy * W + x], P);
}

__global__ void init_extrema(int* ext, int B) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < B * 8) ext[t] = (t % 2 == 0) ? 0x7fffffff : (int)0x80000000;
}

// ext[b*8 + 2*k] = min, ext[b*8 + 2*k + 1] = max of quantity k:
// k = 0 pos_row, 1 neg_row, 2 pos_col, 3 neg_col
__global__ void isr_reduce(const float* __restrict__ gray,
                           const int32_t* __restrict__ dir, int* ext, int H,
                           int W, IsrParams P) {
  const int b = blockIdx.y;
  const int d = dir[b];
  const bool left = d < 2, up = (d % 2) == 1;
  const float* img = gray + (long long)b * H * W;
  const long long n = (long long)H * W;
  float v[8];
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = INFINITY;
    v[2 * k + 1] = -INFINITY;
  }
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    const int y = (int)(t / W), x = (int)(t % W);
    float dr, dc;
    diffs(img, y, x, H, W, left, up, P, &dr, &dc);
    const float q[4] = {fminf(fmaxf(dr, 0.0f), P.clip),
                        fmaxf(fminf(dr, 0.0f), -P.clip),
                        fminf(fmaxf(dc, 0.0f), P.clip),
                        fmaxf(fminf(dc, 0.0f), -P.clip)};
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = fminf(v[2 * k], q[k]);
      v[2 * k + 1] = fmaxf(v[2 * k + 1], q[k]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = fminf(v[2 * k], __shfl_down_sync(0xffffffffu, v[2 * k], off));
      v[2 * k + 1] =
          fmaxf(v[2 * k + 1], __shfl_down_sync(0xffffffffu, v[2 * k + 1], off));
    }
  }
  __shared__ float warp_v[kThreads / 32][8];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0)
    for (int k = 0; k < 8; ++k) warp_v[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x < 8) {
    const int k = threadIdx.x;
    float r = warp_v[0][k];
    for (int wi = 1; wi < kThreads / 32; ++wi)
      r = (k % 2 == 0) ? fminf(r, warp_v[wi][k]) : fmaxf(r, warp_v[wi][k]);
    if (k % 2 == 0)
      atomicMin(&ext[b * 8 + k], enc(r));
    else
      atomicMax(&ext[b * 8 + k], enc(r));
  }
}

__global__ void isr_write(const float* __restrict__ gray,
                          const int32_t* __restrict__ dir,
                          const int* __restrict__ ext, float* __restrict__ out,
                          int H, int W, IsrParams P) {
  const int b = blockIdx.y;
  const long long n = (long long)H * W;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int d = dir[b];
  const bool left = d < 2, up = (d % 2) == 1;
  const float* img = gray + (long long)b * n;
  const int y = (int)(t / W), x = (int)(t % W);
  float dr, dc;
  diffs(img, y, x, H, W, left, up, P, &dr, &dc);
  float e[8];
  for (int k = 0; k < 8; ++k) e[k] = dec(ext[b * 8 + k]);
  const float dd[2] = {dr, dc};
  float ic[2];
  for (int r = 0; r < 2; ++r) {
    const float pos = fminf(fmaxf(dd[r], 0.0f), P.clip);
    const float neg = fmaxf(fminf(dd[r], 0.0f), -P.clip);
    const float pmin = e[4 * r], pmax = e[4 * r + 1];
    const float nmin = e[4 * r + 2], nmax = e[4 * r + 3];
    const float pn = (pos - pmin) / (pmax - pmin + 1e-8f);
    const float nn = (neg - nmin) / (nmax - nmin + 1e-8f) - 1.0f;
    ic[r] = pn + nn;
  }
  out[(long long)b * n + t] = ic[0] * 0.5f + ic[1] * 0.5f;
}

}  // namespace

extern "C" {

// gray: [B,H,W] float32 contiguous; dir: [B] int32 in [0,4); ext: [B*8] int32
// scratch; out: [B,H,W] float32. lo, k = (hi-lo)/255, thr and clip (already
// scaled by log(hi) - log(lo)) as float32. Launches three kernels on
// `stream` and returns cudaGetLastError().
int cmda_batched_isr(const float* gray, const int32_t* dir, int* ext,
                     float* out, int B, int H, int W, float lo, float k,
                     float thr, float clip, int shift, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  IsrParams P{lo, k, thr, clip, shift};
  init_extrema<<<(B * 8 + 255) / 256, 256, 0, st>>>(ext, B);
  const long long n = (long long)H * W;
  const long long blocks = (n + kThreads - 1) / kThreads;
  // pass 1: a few pixels per thread keeps the atomics per image low
  const int reduce_blocks = (int)(blocks < 128 ? blocks : 128);
  isr_reduce<<<dim3(reduce_blocks, B), kThreads, 0, st>>>(gray, dir, ext, H,
                                                          W, P);
  isr_write<<<dim3((unsigned)blocks, B), kThreads, 0, st>>>(gray, dir, ext,
                                                            out, H, W, P);
  return (int)cudaGetLastError();
}

const char* cmda_batched_isr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

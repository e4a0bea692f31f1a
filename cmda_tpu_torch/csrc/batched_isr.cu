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
// The normalisation divides, as the reference does, rather than multiply by
// a reciprocal: in the dead zone (d = 0) the quotient is then exactly 1 and
// the pixel exactly 0, where a reciprocal leaves +-6e-8. A 7x7 patch of
// such pixels is a token the events encoder's LayerNorms then scale up
// from exactly 0 (eps 1e-6, a factor of ~1000 each), so at a randomly
// initialised MiT-b5 a dark DarkZurich frame's gradients followed the
// rounding: the first moments of a b5 step moved by 92% of their largest
// between the two forms (NVIDIA H100 80GB HBM3).
//
// Bound on the H100: device memory. The function reads gray once and writes
// out once, 8 bytes a pixel: 2.25 MB at the image-only serving shape
// [1,440,640] (0.67 us at 3.35 TB/s), 4.2 MB at the DACS step's [2,512,512]
// (1.25 us). Its ~35 operations and 3 logs a pixel are far below that. At
// these sizes what sets the time is launch latency and the dependency of
// every output on the whole frame's extrema, not bytes.
//
// Design: one cooperative launch, sized to the blocks that are resident at
// once, with one grid-wide barrier. The frame's pixels are cut into equal
// chunks of one image, kThreads x ppt pixels (ppt chosen at launch, the
// least multiple of kGroup from kMinPpt up whose chunks all fit the
// resident blocks); a block takes chunks blockIdx.x, + gridDim.x, ...
//   before the barrier each thread computes d_row and d_col of its pixels,
//          kGroup pixels' loads in flight at once (2-D indices stepped
//          without a division per pixel; the gray value's log shared by
//          both), and the block reduces the 8 extrema (min/max of pos/neg,
//          row and column) of its chunk into its own slot of a partials
//          buffer, which every launch writes whole, so nothing needs
//          resetting;
//   after it each block reduces the partials of its chunk's image (coalesced
//          16-byte loads; min and max do not depend on order, so the result
//          is the same bits every run) and writes the normalised average.
// The d of a block's first chunk are held in shared memory across the
// barrier (8 bytes a pixel: 32 KB a block at ppt = 16, so the card holds
// ~4M pixels' d at once), so gray is read once; a block that owns further
// chunks (frames larger than that) computes their d again after it.
// Shared memory rather than registers: the registers a thread would need to
// hold 16 pixels cut the resident blocks, and with them the threads that
// hide the logs' latency. Why a cooperative grid and not one thread-block
// cluster per image: a cluster has at most 16 blocks, so a single frame, the
// serving path's case, would run on 16 of the 132 SMs. logf, not __logf,
// and the log arguments' products and sums rounded separately: the dead
// zone compares |d| with thr, and a faster or fused form would move pixels
// across it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;    // pixels whose loads are in flight together
constexpr int kMinPpt = 4;   // pixels per thread, a multiple of kGroup,
constexpr int kMaxPpt = 32;  // from kMinPpt to kMaxPpt

struct IsrParams {
  float lo, k, thr, clip;
  int shift;
};

// log(v*k + lo), the product and the sum rounded separately as in the
// reference (no FMA contraction)
__device__ __forceinline__ float log_arg(float v, const IsrParams& P) {
  return logf(__fadd_rn(__fmul_rn(v, P.k), P.lo));
}

__device__ __forceinline__ float dead_zone(float d, const IsrParams& P) {
  return fabsf(d) <= P.thr ? 0.0f : d;
}

// The gray value of a pixel and of its row and column neighbours: the row
// shift runs along x, the column shift along y. Both candidates of each
// shift are loaded, so no load waits for the image's direction.
struct Taps {
  float g, row, col;
};

__device__ __forceinline__ Taps load_taps(const float* img, int y, int x,
                                          int H, int W, bool left, bool up,
                                          int s) {
  const float* r = img + y * W;
  const float g = r[x];
  const float rl = r[x < W - s ? x + s : x], rr = r[x < s ? x : x - s];
  const float cu = img[(y < H - s ? y + s : y) * W + x];
  const float cd = img[(y < s ? y : y - s) * W + x];
  return Taps{g, left ? rl : rr, up ? cu : cd};
}

// (d_row, d_col) of a pixel from its taps; the gray value's log is shared
__device__ __forceinline__ float2 diffs(const Taps& t, const IsrParams& P) {
  const float lg = log_arg(t.g, P);
  return make_float2(dead_zone(log_arg(t.row, P) - lg, P),
                     dead_zone(log_arg(t.col, P) - lg, P));
}

// v[2k] = min, v[2k+1] = max of quantity k: 0 pos_row, 1 neg_row, 2 pos_col,
// 3 neg_col
__device__ __forceinline__ void ext_init(float* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = INFINITY;
    v[2 * k + 1] = -INFINITY;
  }
}

__device__ __forceinline__ void ext_add(float* v, float2 d, float clip) {
  const float q[4] = {fminf(fmaxf(d.x, 0.0f), clip),
                      fmaxf(fminf(d.x, 0.0f), -clip),
                      fminf(fmaxf(d.y, 0.0f), clip),
                      fmaxf(fminf(d.y, 0.0f), -clip)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = fminf(v[2 * k], q[k]);
    v[2 * k + 1] = fmaxf(v[2 * k + 1], q[k]);
  }
}

__device__ __forceinline__ void ext_merge(float* v, const float* u) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = fminf(v[2 * k], u[2 * k]);
    v[2 * k + 1] = fmaxf(v[2 * k + 1], u[2 * k + 1]);
  }
}

// The block's extrema, in every thread's v on return. `red` is shared
// scratch; the caller syncs before reusing it.
__device__ __forceinline__ void block_extrema(float* v,
                                              float (*red)[8]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float u[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) u[k] = __shfl_xor_sync(0xffffffffu, v[k], off);
    ext_merge(v, u);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) red[warp][k] = v[k];
  }
  __syncthreads();
  ext_init(v);
#pragma unroll
  for (int wi = 0; wi < kThreads / 32; ++wi) ext_merge(v, red[wi]);
}

// An image's extrema as the normalisation takes them: per direction r
// (row, column) n[4r] = min pos, n[4r+1] = max pos - min pos + 1e-8,
// n[4r+2] = min neg, n[4r+3] = max neg - min neg + 1e-8.
__device__ __forceinline__ void norm_of(const float* e, float* n) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    n[4 * r] = e[4 * r];
    n[4 * r + 1] = e[4 * r + 1] - e[4 * r] + 1e-8f;
    n[4 * r + 2] = e[4 * r + 2];
    n[4 * r + 3] = e[4 * r + 3] - e[4 * r + 2] + 1e-8f;
  }
}

// The normalised average of one pixel.
__device__ __forceinline__ float isr_value(float2 d, const float* n,
                                           float clip) {
  const float dd[2] = {d.x, d.y};
  float ic[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float pos = fminf(fmaxf(dd[r], 0.0f), clip);
    const float neg = fmaxf(fminf(dd[r], 0.0f), -clip);
    ic[r] = __fdiv_rn(pos - n[4 * r], n[4 * r + 1])
            + (__fdiv_rn(neg - n[4 * r + 2], n[4 * r + 3]) - 1.0f);
  }
  return ic[0] * 0.5f + ic[1] * 0.5f;
}

// (y, x) of flat pixel p, p + kThreads, p + 2*kThreads, ... of a row-major
// image W wide: one division up front, then two adds and a compare per step.
struct PixelStep {
  int y, x, dy, dx, W;
  __device__ __forceinline__ PixelStep(int p, int W_) : W(W_) {
    y = p / W;
    x = p - y * W;
    dy = kThreads / W;
    dx = kThreads - dy * W;
  }
  __device__ __forceinline__ void next() {
    y += dy;
    x += dx;
    if (x >= W) {
      x -= W;
      ++y;
    }
  }
};

// One chunk of image b: pixels p0 + threadIdx.x + kThreads * k, k < ppt,
// of the H*W pixels of the image (flat, row-major).
struct Chunk {
  int b, p0;
  bool left, up;
  const float* img;
  __device__ __forceinline__ Chunk(int item, int chunks, int item_px,
                                   const float* gray, const int32_t* dir,
                                   int hw) {
    b = item / chunks;
    p0 = (item - b * chunks) * item_px;
    const int d = dir[b];
    left = d < 2;
    up = (d % 2) == 1;
    img = gray + (long long)b * hw;
  }
};

// d of pixels k0 .. k0+kGroup-1 of the thread's share of a chunk, `it` at
// pixel k0 on entry and at k0+kGroup on return. All the group's loads are
// issued before the first log, so a thread waits on memory once per group;
// a pixel past the image's end reads its last row and is not used.
__device__ __forceinline__ void group_diffs(const Chunk& ch, PixelStep& it,
                                            int H, int W,
                                            const IsrParams& P, float2* d) {
  Taps t[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    t[j] = load_taps(ch.img, min(it.y, H - 1), it.x, H, W, ch.left, ch.up,
                     P.shift);
    it.next();
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) d[j] = diffs(t[j], P);
}

__global__ void __launch_bounds__(kThreads)
isr_grid_kernel(const float* __restrict__ gray,
                const int32_t* __restrict__ dir, float* partials,
                float* __restrict__ out, int H, int W, int chunks, int ppt,
                int n_items, IsrParams P) {
  extern __shared__ float2 held[];   // [ppt][kThreads]: d of the first chunk
  __shared__ float red[kThreads / 32][8];
  const int hw = H * W, item_px = kThreads * ppt;

  // 1. each chunk's extrema into its slot of `partials`
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Chunk ch(item, chunks, item_px, gray, dir, hw);
    const int first = ch.p0 + threadIdx.x;
    float v[8];
    ext_init(v);
    PixelStep it(first, W);
    for (int k0 = 0; k0 < ppt; k0 += kGroup) {
      float2 d[kGroup];
      group_diffs(ch, it, H, W, P, d);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int k = k0 + j;
        if (first + k * kThreads < hw) {
          ext_add(v, d[j], P.clip);
          if (item == blockIdx.x) held[k * kThreads + threadIdx.x] = d[j];
        }
      }
    }
    block_extrema(v, red);
    if (threadIdx.x == 0) {
      float4* slot = reinterpret_cast<float4*>(partials + item * 8);
      slot[0] = make_float4(v[0], v[1], v[2], v[3]);
      slot[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
  }

  cg::this_grid().sync();

  // 2. the image's extrema from its chunks' partials (an index past the
  // last chunk reads the last chunk again, which leaves a min or max as it
  // is), then the output
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Chunk ch(item, chunks, item_px, gray, dir, hw);
    const int first = ch.p0 + threadIdx.x;
    const float4* q =
        reinterpret_cast<const float4*>(partials + ch.b * chunks * 8);
    float e[8];
    ext_init(e);
    for (int c0 = threadIdx.x; c0 < chunks; c0 += kGroup * kThreads) {
      float4 u[kGroup][2];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int c = min(c0 + j * kThreads, chunks - 1);
        u[j][0] = __ldcg(q + 2 * c);
        u[j][1] = __ldcg(q + 2 * c + 1);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float f[8] = {u[j][0].x, u[j][0].y, u[j][0].z, u[j][0].w,
                            u[j][1].x, u[j][1].y, u[j][1].z, u[j][1].w};
        ext_merge(e, f);
      }
    }
    block_extrema(e, red);
    float n[8];
    norm_of(e, n);
    PixelStep it(first, W);
    float* o = out + (long long)ch.b * hw;
    for (int k0 = 0; k0 < ppt; k0 += kGroup) {
      float2 d[kGroup];
      if (item == blockIdx.x) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          d[j] = held[(k0 + j) * kThreads + threadIdx.x];
      } else {
        group_diffs(ch, it, H, W, P, d);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int p = first + (k0 + j) * kThreads;
        if (p < hw) o[p] = isr_value(d[j], n, P.clip);
      }
    }
    __syncthreads();
  }
}

size_t held_bytes(int ppt) { return (size_t)ppt * kThreads * sizeof(float2); }

// Blocks of isr_grid_kernel resident at once on the current device with
// ppt pixels a thread (the most a cooperative launch may have), cached per
// device and ppt.
int resident_blocks(int ppt, int* out) {
  constexpr int kDevices = 64, kSteps = kMaxPpt / kGroup;
  static int cache[kDevices][kSteps + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int* slot = dev < kDevices ? &cache[dev][ppt / kGroup] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *out = *slot;
    return 0;
  }
  // above 48 KB a block's shared memory must be asked for
  err = cudaFuncSetAttribute(isr_grid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)held_bytes(kMaxPpt));
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, isr_grid_kernel, kThreads, held_bytes(ppt));
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *out = per_sm * sms;
  if (slot != nullptr) *slot = *out;
  return 0;
}

}  // namespace

extern "C" {

// gray: [B,H,W] float32 contiguous; dir: [B] int32 in [0,4); partials:
// float32 scratch of at least B * ceil(H*W/1024) * 8 elements, uninitialised
// (the launch writes every element it reads); out: [B,H,W] float32. lo,
// k = (hi-lo)/255, thr and clip (already scaled by log(hi) - log(lo)) as
// float32; B*H*W below 2^31. One cooperative launch on `stream`; returns its
// CUDA error.
int cmda_batched_isr(const float* gray, const int32_t* dir, float* partials,
                     float* out, int B, int H, int W, float lo, float k,
                     float thr, float clip, int shift, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const long long hw = (long long)H * W;
  // the fewest pixels per thread whose chunks all fit the resident blocks;
  // past kMaxPpt, blocks loop over chunks
  int ppt = kMinPpt, resident = 0, chunks = 0, n_items = 0;
  for (;; ppt += kGroup) {
    const int err = resident_blocks(ppt, &resident);
    if (err != 0) return err;
    chunks = (int)((hw + kThreads * ppt - 1) / (kThreads * ppt));
    n_items = B * chunks;
    if (n_items <= resident || ppt == kMaxPpt) break;
  }
  if (resident == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = n_items < resident ? n_items : resident;
  IsrParams P{lo, k, thr, clip, shift};
  void* args[] = {(void*)&gray, (void*)&dir, (void*)&partials, (void*)&out,
                  (void*)&H, (void*)&W, (void*)&chunks, (void*)&ppt,
                  (void*)&n_items, (void*)&P};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)isr_grid_kernel, dim3(grid), dim3(kThreads), args,
      held_bytes(ppt), (cudaStream_t)stream);
}

const char* cmda_batched_isr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

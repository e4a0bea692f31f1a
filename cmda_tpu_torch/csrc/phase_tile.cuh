// Helpers shared by the kernels that read an integer-factor half-pixel
// bilinear upsample of NHWC coarse logits through a tile staged in shared
// memory: the phase weights, their per-block tables, the staging of a
// clamped coarse tile, and the choice of a tile and its grid at launch.
//
// Phase weights: output index o = f*i + p samples coarse i-1 / i / i+1
// (clamped at the edges) with d = (p + 0.5)/f - 0.5: w_prev = max(-d, 0),
// w_next = max(d, 0), w_self = 1 - w_prev - w_next
// (cmda_tpu/ops/pallas_ce.py:_phase_weights). At most one of w_prev and
// w_next is non-zero, so every phase is a two-tap blend of coarse i and
// i + step.
//
// Shared-memory layout of a staged tile: [rows][cols][cp] floats with the
// class stride cp = C | 1, odd, so that threads reading one class of
// different coarse columns fall in different banks and the threads of one
// column broadcast; each row padded to a multiple of 4 floats
// (row_stride), so that a blend of two rows runs on float4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace phase_tile {

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

__host__ __device__ __forceinline__ PhaseW phase_weights(int p, int f) {
  float d = ((float)p + 0.5f) / (float)f - 0.5f;
  PhaseW w;
  w.prev = fmaxf(-d, 0.0f);
  w.next = fmaxf(d, 0.0f);
  w.self = 1.0f - w.prev - w.next;
  return w;
}

// One phase as a two-tap blend: self * v[i] + other * v[i + step].
struct PhaseTab {
  float self, other;
  int step;
};

// 2^x in one SFU instruction (ex2.approx.ftz: ~2 ulp, results below 2^-126
// flushed to 0). The softmax takes it of z - max or z - lse, so x <= ~0 and
// the result lies in (0, 1], where the flush is far below float32's
// resolution of the sums it enters.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A fine column's taps in a blended row: z_c = self * R[off + c] +
// other * R[off + step + c] (offsets in floats).
struct ColTap {
  float self, other;
  int off, step;
};

__host__ __device__ __forceinline__ int class_stride(int C) { return C | 1; }

__host__ __device__ __forceinline__ int row_stride(int ncols, int cp) {
  return (ncols * cp + 3) & ~3;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// (q, r) = divmod(e, d) along e = e0, e0 + stride, ...: one division up
// front, then two adds and a compare per step (a runtime division costs
// ~20 instructions, as much as the work of an inner-loop element).
struct StridedDivmod {
  int q, r, dq, dr, d;
  __device__ __forceinline__ StridedDivmod(int e0, int stride, int d_)
      : d(d_) {
    q = e0 / d;
    r = e0 - q * d;
    dq = stride / d;
    dr = stride - dq * d;
  }
  __device__ __forceinline__ void next() {
    q += dq;
    r += dr;
    if (r >= d) {
      r -= d;
      ++q;
    }
  }
};

// tab[p] for p < f, written by the block's threads; needs a __syncthreads()
// before it is read.
__device__ __forceinline__ void fill_phase_tab(PhaseTab* tab, int f) {
  for (int p = threadIdx.x; p < f; p += blockDim.x) {
    const PhaseW w = phase_weights(p, f);
    tab[p].self = w.self;
    tab[p].other = w.prev + w.next;
    tab[p].step = w.prev > 0.0f ? -1 : 1;
  }
}

// dst[r][c'][k] = x[b, clamp(r0 + r), clamp(c0 + c'), k] in float, for
// r < nrows, c' < ncols, k < C; rows clamp to [0, h), columns to [0, w), so
// the halo repeats the edge row and column as the upsample's clamped taps
// do. Consecutive threads read consecutive addresses of one coarse row
// segment (contiguous in NHWC away from the clamps). float32 goes by
// cp.async, every element of the tile in flight at once: the caller
// commits, waits and synchronises. bfloat16 is converted through registers.
__device__ __forceinline__ void stage_element(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}
__device__ __forceinline__ void stage_element(float* dst,
                                              const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

template <typename T>
__device__ __forceinline__ void stage_coarse_tile(
    float* __restrict__ dst, const T* __restrict__ x, int b, int h, int w,
    int C, int cp, int r0, int nrows, int c0, int ncols) {
  const int seg = ncols * C, rs = row_stride(ncols, cp);
  for (int r = 0; r < nrows; ++r) {
    const int gr = clampi(r0 + r, 0, h - 1);
    const T* row = x + ((long long)b * h + gr) * w * C;
    float* out = dst + r * rs;
    StridedDivmod it(threadIdx.x, blockDim.x, C);   // (column, class)
    for (int e = threadIdx.x; e < seg; e += blockDim.x, it.next()) {
      const int gc = clampi(c0 + it.q, 0, w - 1);
      stage_element(out + it.q * cp + it.r, row + (long long)gc * C + it.r);
    }
  }
}

// out[k] = wa * a[k] + wb * b[k] over one padded row of n4 float4, the
// block's threads striding over it. All three 16-byte aligned.
__device__ __forceinline__ void blend_rows(float* out, const float* a,
                                           const float* b, float wa, float wb,
                                           int n4) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int v = threadIdx.x; v < n4; v += blockDim.x) {
    const float4 p = a4[v], q = b4[v];
    o4[v] = make_float4(wa * p.x + wb * q.x, wa * p.y + wb * q.y,
                        wa * p.z + wb * q.z, wa * p.w + wb * q.w);
  }
}

// (image, first coarse row, first coarse column) of block blockIdx.x over a
// grid of B x ceil(h/ti) x ceil(w/tj) tiles, columns fastest.
struct TileOrigin {
  int b, i0, j0;
  __device__ __forceinline__ TileOrigin(int h, int w, int ti, int tj) {
    const int ntj = (w + tj - 1) / tj, nti = (h + ti - 1) / ti;
    int blk = blockIdx.x;
    j0 = (blk % ntj) * tj;
    blk /= ntj;
    i0 = (blk % nti) * ti;
    b = blk / nti;
  }
};

// ---------------------------------------------------------------- host

constexpr size_t kSmemBudget = 64 * 1024;
constexpr size_t kSmemDefault = 48 * 1024;

// ti x tj coarse pixels a block owns, and the dynamic shared memory it takes
struct Tile {
  int ti, tj;
  size_t smem;
};

// The largest tile up to ti0 x tj0 coarse pixels (no larger than the image)
// whose shared memory fits kSmemBudget, halving the columns first; at 1 x 1
// the kernel takes what it needs (a launch above 227 KB fails and raises).
template <typename SmemOf>
inline Tile pick_tile(SmemOf smem_of, int ti0, int tj0, int h, int w, int C,
                      int fh, int fw) {
  int ti = max(1, min(ti0, h)), tj = max(1, min(tj0, w));
  size_t s;
  while ((s = smem_of(ti, tj, C, fh, fw)) > kSmemBudget && (ti > 1 || tj > 1)) {
    if (tj > 1 && tj >= ti) tj = (tj + 1) / 2;
    else ti = (ti + 1) / 2;
  }
  return {ti, tj, s};
}

inline long long grid_of(const Tile& t, int B, int h, int w) {
  return (long long)B * ((h + t.ti - 1) / t.ti) * ((w + t.tj - 1) / t.tj);
}

// Above 48 KB a kernel must be given the dynamic shared-memory attribute.
template <typename K>
inline int allow_smem(K kernel, size_t smem) {
  if (smem <= kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace phase_tile

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
// either direction. A label outside [0, C) that is not ignore_index selects
// no class (z_label = 0), as the TPU kernel's one-hot select does.
//
// Math of the upsample (phase_tile.cuh): fine row y = fh*i + p is a two-tap
// blend of coarse rows i and clamp(i + step_p) with the fixed weights of
// phase p; columns likewise. The row blend is taken first, then the column
// blend, as in the TPU kernels.
//
// At the flagship shape [2,128,128,19] f32 -> [2,512,512] (fh = fw = 4) the
// inputs are the logits (2.5 MB), labels, weights and lse (2.1 MB each).
//
// 1. Forward, ce_fwd_kernel. Replaces cmda_tpu/ops/pallas_ce.py::_fwd_call
//    (kernel body _ce_fwd_kernel). Bound: device memory, ~2 us for the
//    bytes above; its ~13 operations per (pixel, class) are about as long
//    at the fp32 rate. What held the one-thread-per-pixel design back was
//    ~114 global loads per fine pixel, the row blend recomputed by each of
//    the fw pixels that share it, and a data-dependent online softmax.
//    Design: a block owns TI x TJ coarse pixels of one image (2 x 32 at the
//    flagship: 8 x 128 fine pixels, 512 blocks). It stages coarse rows
//    i0-1 .. i0+TI and columns j0-1 .. j0+TJ, all classes, in shared memory
//    (the halo rows and columns written as clamped copies) together with
//    the tile's fine labels and weights, all by cp.async, so one block
//    waits on device memory once; takes each row blend once into shared
//    memory (R, one row per fine row of the tile); and gives each fine
//    pixel z_c from two reads of R and two FMAs. The softmax is a max pass
//    and a sum-exp pass over C: exactly C exps per pixel, no branch on the
//    data; at C = 19 the class loops unroll and z stays in registers. Each
//    block writes a partial sum of nll (a shuffle tree in a fixed order);
//    the last block to finish (an integer counter) sums the partials in
//    index order and divides by B*H*W, so the loss takes one launch. No
//    float atomicAdd: the loss is bitwise the same from run to run. It
//    writes each fine pixel's lse for the backward.
// 2. dx, ce_dx_kernel. Replaces _bwd_dx_call (kernel body _ce_bwd_kernel):
//       dx[b,i,j,c] = sum over fine (y,x) of Wr(y,i) Wc(x,j)
//                     * (exp(z_c - lse) - [label == c]) * g * wt / (B*H*W)
//    where Wr(y,i) is the weight of coarse row i in fine row y, the clamped
//    taps folded onto rows 0 and h-1 included (the TPU kernel's
//    _shift_t_prev/_shift_t_next). Bound: it reads the logits, labels,
//    weights and lse and writes dx, ~3.4 us; ~25 operations per (pixel,
//    class) take ~3.7 us at the fp32 rate, so the operations bound it. The
//    gather design (one thread per coarse output) computed every fine
//    pixel's exp 4 times and reread its label, weight and lse once per
//    (output, class): ~300M loads for 2.5 MB of output. Design: a block owns
//    TI x TJ coarse outputs x all C and writes each once. It stages coarse
//    rows i0-2 .. i0+TI+1 and columns j0-2 .. j0+TJ+1 (cp.async), then
//    streams over the fine rows whose taps reach the tile (the tile's own
//    and ~fh/2 on each side): (1) the fine row's row blend into shared
//    memory, while the label, lse and weight of the next fine row's pixels
//    arrive by cp.async into the other of two buffers, so no row waits on
//    device memory; (2) one thread per (coarse column, class) of coarse
//    columns j0-1 .. j0+TJ takes dz = (exp(z_c - lse) - onehot) * g*wt/N of
//    the column's fw fine pixels (fw independent exps) and reduces them at
//    once to three partial sums: the self taps, and the other taps that
//    point left and right; (3) each (coarse column j, class) of the tile
//    adds its self sum, the left sum of column j+1 and the right sum of
//    column j-1 (at the image's edge columns the clamped taps fold back
//    onto j), and adds that, times the row weight, into its <= 2 coarse
//    rows of a per-block accumulator owned by one thread. The loop order
//    fixes every sum: no atomics, deterministic. Each fine pixel's exp is
//    computed ~1.5 times (the halo shared with neighbouring blocks) instead
//    of 4; the dx stores are coalesced, with the bf16 conversion at the
//    store.
// 3. dweight, ce_dweight_kernel. Replaces _bwd_dw_call (kernel body
//    _ce_dw_kernel):
//       dwt[b,y,x] = (lse - z_label) * g / (B*H*W), 0 where ignored,
//    with lse from the forward, so a fine pixel needs only its label's
//    class: two 2-tap row blends and a column blend. Bound: bytes (logits
//    and labels in, dwt out, ~6.7 MB at the flagship, ~2.0 us; the
//    function could recompute lse from the logits it reads, so the lse this
//    kernel reads is not counted). The first design (one thread per fine
//    pixel) paid 64-bit index divisions and up to nine scattered 4-byte
//    gathers of the label's class per pixel, each its own sector, with no
//    reuse between the 16 fine pixels that share a coarse tap. Design: a
//    block owns 4 x 32 coarse pixels at factor 4 (16 x 128 fine pixels, 256
//    blocks at the flagship, all resident at once) and stages coarse rows
//    i0-1 .. i0+4 and columns j0-1 .. j0+32, every class, in shared memory
//    by stage_coarse_tile, as the forward and dx do. At C = 19 and factor 4
//    each thread loads the labels and lse of its 2 units (a unit: the 4
//    fine pixels of one coarse column in one fine row) as 16-byte vectors
//    before the tile is staged, so the block waits on device memory once,
//    then reads 4 shared-memory words a pixel and writes the unit's 4
//    dweights as one vector. Any other C or factor (or an unaligned
//    pointer) takes a thread per fine pixel. Measured against the design's
//    variants on the card (PERF.md section 6): 2 coarse rows a tile (more
//    halo), 512 threads and splitting the wait in two were each slower.
//
// Tensor cores are not used: the blends are 2-tap stencils, so as products
// with a dense interpolation matrix their reduction depth (TI+2 coarse rows)
// is a few mostly-zero terms, far below what wgmma needs to pay, and TF32
// would break the loss's 1e-5 tolerance. The coarse tile is staged by
// cp.async, not TMA: it is one 10-20 KB load per block with a halo of
// clamped copies, which a TMA box would zero-fill. The kernels are bound by
// latency more than by either roofline (every block is resident at once at
// the flagship shape), so what matters is that each block waits on device
// memory once and keeps several independent exps in flight. Inner loops
// step (index, class) pairs with StridedDivmod instead of dividing, and
// take exp as exp2 of a pre-scaled argument.
//
// Tile sizes are picked at launch from C and the factors (pick_tile): the
// target is 8 fine rows (the dweight's 16) by 32 coarse columns, halved
// until the block's shared memory fits kSmemBudget; above 48 KB the kernel
// is given the dynamic shared-memory attribute. The upstream gradient g is read on the
// device from a pointer, so the backward never waits on the host.

#include "phase_tile.cuh"

namespace {

using phase_tile::allow_smem;
using phase_tile::blend_rows;
using phase_tile::class_stride;
using phase_tile::clampi;
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
using phase_tile::store_f;
using phase_tile::StridedDivmod;
using phase_tile::Tile;
using phase_tile::TileOrigin;

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------- forward

// Shared memory: the coarse tile (ti+2) x (tj+2) x cp, the row blends
// (ti*fh) x (tj+2) x cp, the tile's fine labels and weights, the phase
// tables.
size_t fwd_smem(int ti, int tj, int C, int fh, int fw) {
  const size_t rs = row_stride(tj + 2, class_stride(C));
  const size_t nfine = (size_t)ti * fh * tj * fw;
  return ((ti + 2) + (size_t)ti * fh) * rs * 4 + 2 * nfine * 4
         + (size_t)tj * fw * sizeof(ColTap)
         + (size_t)(fh + fw) * sizeof(PhaseTab);
}

// lse and z_label of one fine pixel whose logits are
// z_c = self * r0[c] + other * r1[c]: a max pass, then a sum of exp2 of
// pre-scaled arguments, exactly C exps and no branch on the data. With
// kC > 0 (C known when compiled) the loops unroll and z stays in registers.
template <int kC>
__device__ __forceinline__ float2 pixel_lse(const float* r0, const float* r1,
                                            float self, float other, int C,
                                            int lbl) {
  float m = -INFINITY, s = 0.0f, z_lbl = 0.0f;
  if constexpr (kC > 0) {
    float z[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      z[c] = self * r0[c] + other * r1[c];
      m = fmaxf(m, z[c]);
    }
    const float m2 = m * kLog2e;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      s += exp2_approx(fmaf(z[c], kLog2e, -m2));
      z_lbl = c == lbl ? z[c] : z_lbl;
    }
  } else {
    for (int c = 0; c < C; ++c) m = fmaxf(m, self * r0[c] + other * r1[c]);
    const float m2 = m * kLog2e;
    for (int c = 0; c < C; ++c) {
      const float z = self * r0[c] + other * r1[c];
      s += exp2_approx(fmaf(z, kLog2e, -m2));
      z_lbl = c == lbl ? z : z_lbl;
    }
  }
  return make_float2(m + __logf(s), z_lbl);
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
              const float* __restrict__ wt, float* __restrict__ lse_out,
              float* __restrict__ partials, unsigned int* __restrict__ done,
              float* __restrict__ loss, int h, int w, int C_arg, int fh,
              int fw, int ignore_index, float n_total, int ti, int tj) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = kC > 0 ? kC : C_arg;
  const int cp = class_stride(C), xc = tj + 2, nfr = ti * fh, nfc = tj * fw;
  const int rsx = row_stride(xc, cp);   // floats per staged or blended row
  const TileOrigin o(h, w, ti, tj);
  float* xs = smem;
  float* rs = xs + (ti + 2) * rsx;
  int* p_lbl = (int*)(rs + nfr * rsx);
  float* p_wt = (float*)(p_lbl + nfr * nfc);
  ColTap* coltap = (ColTap*)(p_wt + nfr * nfc);   // per fine column
  PhaseTab* rtab = (PhaseTab*)(coltap + nfc);
  const int H = h * fh, W = w * fw;
  fill_phase_tab(rtab, fh);
  // fine column fc = fw*lj + q reads blended columns lj+1 and lj+1+step
  for (int fc = threadIdx.x; fc < nfc; fc += kThreads) {
    const int lj = fc / fw;
    const PhaseW pw = phase_weights(fc - lj * fw, fw);
    coltap[fc] = ColTap{pw.self, pw.prev + pw.next, (lj + 1) * cp,
                        (pw.prev > 0.0f ? -1 : 1) * cp};
  }
  // the coarse tile and the tile's fine labels and weights, all in flight
  stage_coarse_tile(xs, x, o.b, h, w, C, cp, o.i0 - 1, ti + 2, o.j0 - 1, xc);
  {
    StridedDivmod it(threadIdx.x, kThreads, nfc);   // (fine row, column)
    for (int e = threadIdx.x; e < nfr * nfc; e += kThreads, it.next()) {
      const int y = o.i0 * fh + it.q, xx = o.j0 * fw + it.r;
      if (y >= H || xx >= W) continue;
      const long long pix = ((long long)o.b * H + y) * W + xx;
      __pipeline_memcpy_async(p_lbl + e, labels + pix, 4);
      if (wt != nullptr) __pipeline_memcpy_async(p_wt + e, wt + pix, 4);
    }
  }
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
    for (int e = threadIdx.x; e < nfr * n4; e += kThreads, it.next()) {
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

  float nll_sum = 0.0f;
  StridedDivmod it(threadIdx.x, kThreads, nfc);   // (fine row, fine column)
  for (int e = threadIdx.x; e < nfr * nfc; e += kThreads, it.next()) {
    const int fr = it.q, fc = it.r;
    const int y = o.i0 * fh + fr, xx = o.j0 * fw + fc;
    if (y >= H || xx >= W) continue;
    const int lbl = p_lbl[e];
    const ColTap ct = coltap[fc];
    const float* r0 = rs + fr * rsx + ct.off;
    const float2 lz = pixel_lse<kC>(r0, r0 + ct.step, ct.self, ct.other, C,
                                    lbl);
    if (lse_out != nullptr) lse_out[((long long)o.b * H + y) * W + xx] = lz.x;
    if (lbl != ignore_index)
      nll_sum += (lz.x - lz.y) * (wt != nullptr ? p_wt[e] : 1.0f);
  }
  const float total = block_sum(nll_sum);

  // the last block to finish sums the partials in index order (double
  // accumulators, a fixed tree) and resets the counter: no float atomics,
  // so the loss is the same bits from run to run
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  __shared__ double sums[kThreads];
  double acc = 0.0;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads)
    acc += (double)__ldcg(partials + k);
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) sums[threadIdx.x] += sums[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    loss[0] = (float)sums[0] / n_total;
    *done = 0u;
  }
}

// --------------------------------------------------------------------- dx

// Shared memory: the coarse tile (ti+4) x (tj+4) x cp and one row blend
// (tj+4) x cp, in padded rows; the accumulator ti x tj x cp; the three
// partial column sums
// 3 x (tj+2) x cp, two buffers of the strip's raw label, lse and weight
// (2 x 3 x ns, ns = (tj+2)*fw fine columns), the strip's label, coef and
// scaled lse (3 x ns), the phase tables.
size_t dx_smem(int ti, int tj, int C, int fh, int fw) {
  const size_t cp = class_stride(C), rs = row_stride(tj + 4, cp);
  const size_t ns = (size_t)(tj + 2) * fw;
  return ((ti + 4) * rs + rs + ((size_t)ti * tj + 3 * (tj + 2)) * cp) * 4
         + (2 * 3 + 3) * ns * 4 + (size_t)(fh + fw) * sizeof(PhaseTab);
}

// Which rows of the tile fine row y adds to: coarse rows ii = y / fh and
// clamp(ii + step), tile-relative, each only if it lies in the tile and has
// a non-zero weight.
struct RowTaps {
  PhaseTab ph;
  int ta, tb;
  bool in_a, in_b;
  __device__ __forceinline__ RowTaps(int y, int fh, int h, int i0, int ti,
                                     const PhaseTab* rtab) {
    const int ii = y / fh;
    ph = rtab[y - ii * fh];
    ta = ii - i0;
    tb = clampi(ii + ph.step, 0, h - 1) - i0;
    in_a = ta >= 0 && ta < ti && ph.self != 0.0f;
    in_b = tb >= 0 && tb < ti && ph.other != 0.0f;
  }
  __device__ __forceinline__ bool any() const { return in_a || in_b; }
};

// The first fine row at or after y (and before y_hi) that adds to the tile;
// y_hi if none. The same for every thread of the block.
__device__ __forceinline__ int next_row(int y, int y_hi, int fh, int h,
                                        int i0, int ti, const PhaseTab* rtab) {
  while (y < y_hi && !RowTaps(y, fh, h, i0, ti, rtab).any()) ++y;
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dx_kernel(const float* __restrict__ g, const T* __restrict__ x,
             const int32_t* __restrict__ labels, const float* __restrict__ wt,
             const float* __restrict__ lse, T* __restrict__ dx, int h, int w,
             int C, int fh, int fw, int ignore_index, float n_total, int ti,
             int tj) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cp = class_stride(C), xc = tj + 4, ns = (tj + 2) * fw;
  const int rsx = row_stride(xc, cp);   // floats per staged or blended row
  const int nsc = (tj + 2) * cp;   // floats of one partial column sum
  const TileOrigin o(h, w, ti, tj);
  float* xs = smem;
  float* rrow = xs + (ti + 4) * rsx;
  float* acc = rrow + rsx;
  float* col_self = acc + ti * tj * cp;   // sum of self * dz of column sj
  float* col_left = col_self + nsc;   // ... of other * dz, tap to the left
  float* col_right = col_left + nsc;  // ... of other * dz, tap to the right
  int* raw_lbl = (int*)(col_right + nsc);       // [2][ns]
  float* raw_lse = (float*)(raw_lbl + 2 * ns);  // [2][ns]
  float* raw_wt = raw_lse + 2 * ns;             // [2][ns]
  int* p_lbl = (int*)(raw_wt + 2 * ns);
  float* p_coef = (float*)(p_lbl + ns);
  float* p_lse2 = p_coef + ns;
  PhaseTab* rtab = (PhaseTab*)(p_lse2 + ns);
  PhaseTab* ctab = rtab + fh;
  fill_phase_tab(rtab, fh);
  fill_phase_tab(ctab, fw);
  stage_coarse_tile(xs, x, o.b, h, w, C, cp, o.i0 - 2, ti + 4, o.j0 - 2, xc);
  __pipeline_commit();
  for (int e = threadIdx.x; e < ti * tj * cp; e += kThreads) acc[e] = 0.0f;
  __syncthreads();

  const int H = h * fh, W = w * fw;
  const int x0 = (o.j0 - 1) * fw;   // fine column of strip pixel 0
  const float gs = g[0] / n_total;

  // the strip pixels' label, lse and weight of fine row y, copied into
  // buffer buf asynchronously, one commit group per row; strip pixel sp is
  // always thread sp % kThreads's
  auto fetch = [&](int y, int buf) {
    const long long row = ((long long)o.b * H + y) * W;
    for (int sp = threadIdx.x; sp < ns; sp += kThreads) {
      const int xx = x0 + sp;
      if (xx < 0 || xx >= W) continue;
      __pipeline_memcpy_async(raw_lbl + buf * ns + sp, labels + row + xx, 4);
      __pipeline_memcpy_async(raw_lse + buf * ns + sp, lse + row + xx, 4);
      if (wt != nullptr)
        __pipeline_memcpy_async(raw_wt + buf * ns + sp, wt + row + xx, 4);
    }
    __pipeline_commit();
  };

  // the fine rows whose taps reach the tile, streamed in order with the
  // next row's pixel data in flight while this one is computed
  const int y_hi = (min(o.i0 + ti, h - 1) + 1) * fh;
  int y = next_row(max(o.i0 - 1, 0) * fh, y_hi, fh, h, o.i0, ti, rtab);
  int buf = 0;
  if (y < y_hi) fetch(y, buf);
  __pipeline_wait_prior(1);   // the coarse tile
  __syncthreads();
  while (y < y_hi) {
    const RowTaps rt(y, fh, h, o.i0, ti, rtab);
    const int y_next = next_row(y + 1, y_hi, fh, h, o.i0, ti, rtab);
    if (y_next < y_hi) {
      fetch(y_next, buf ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    // (1) the row blend of fine row y (coarse row y/fh is staged row
    // ta + 2), and each strip pixel's label, coef = g*wt/N (0 where
    // ignored or outside the image) and lse * log2(e), by the thread that
    // fetched it
    {
      const float* a = xs + (rt.ta + 2) * rsx;
      blend_rows(rrow, a, a + rt.ph.step * rsx, rt.ph.self, rt.ph.other,
                 rsx / 4);
      for (int sp = threadIdx.x; sp < ns; sp += kThreads) {
        const int xx = x0 + sp;
        const bool inside = xx >= 0 && xx < W;
        const int lbl = inside ? raw_lbl[buf * ns + sp] : ignore_index;
        p_lbl[sp] = lbl;
        p_coef[sp] = lbl == ignore_index ? 0.0f
                     : wt != nullptr ? gs * raw_wt[buf * ns + sp] : gs;
        p_lse2[sp] = inside ? raw_lse[buf * ns + sp] * kLog2e : 0.0f;
      }
    }
    __syncthreads();

    // (2) per (strip coarse column sj, class): dz of its fw fine pixels,
    // reduced at once into the column's three partial sums: the self taps,
    // and the other taps that point left and right. Column sj's fine
    // pixels read row-blend columns sj .. sj+2.
    {
      StridedDivmod it(threadIdx.x, kThreads, C);   // (column, class)
      for (int e = threadIdx.x; e < (tj + 2) * C; e += kThreads, it.next()) {
        const int sj = it.q, c = it.r;
        const float* rm = rrow + (sj + 1) * cp + c;
        const float left = rm[-cp], mid = rm[0], right = rm[cp];
        float s_self = 0.0f, s_left = 0.0f, s_right = 0.0f;
        for (int q = 0; q < fw; ++q) {
          const int sp = sj * fw + q;
          const PhaseTab cq = ctab[q];
          const float z =
              cq.self * mid + cq.other * (cq.step < 0 ? left : right);
          const float coef = p_coef[sp];
          const float ez = exp2_approx(fmaf(z, kLog2e, -p_lse2[sp]));
          const float dz = coef != 0.0f
              ? (ez - (p_lbl[sp] == c ? 1.0f : 0.0f)) * coef : 0.0f;
          s_self += cq.self * dz;
          if (cq.step < 0) s_left += cq.other * dz;
          else s_right += cq.other * dz;
        }
        const int k = sj * cp + c;
        col_self[k] = s_self;
        col_left[k] = s_left;
        col_right[k] = s_right;
      }
    }
    __syncthreads();

    // (3) coarse column j = j0+lj (strip column lj+1) takes its own self
    // sums, the left taps of column j+1 and the right taps of column j-1;
    // at the image's first and last column the clamped taps fold back onto
    // the column itself. Then the row weights into the tile; (lj, c) is
    // always the same thread's, so acc needs no barrier here.
    {
      StridedDivmod it(threadIdx.x, kThreads, C);   // (column, class)
      for (int e = threadIdx.x; e < tj * C; e += kThreads, it.next()) {
        const int lj = it.q, c = it.r, j = o.j0 + lj;
        const int k = (lj + 1) * cp + c;
        float d = col_self[k] + col_left[k + cp] + col_right[k - cp];
        if (j == 0) d += col_left[k];
        if (j == w - 1) d += col_right[k];
        if (rt.in_a) acc[(rt.ta * tj + lj) * cp + c] += rt.ph.self * d;
        if (rt.in_b) acc[(rt.tb * tj + lj) * cp + c] += rt.ph.other * d;
      }
    }
    y = y_next;
    buf ^= 1;
  }
  __syncthreads();

  const int seg = tj * C;
  StridedDivmod it(threadIdx.x, kThreads, C);   // (tile pixel, class)
  for (int e = threadIdx.x; e < ti * seg; e += kThreads, it.next()) {
    const int li = it.q / tj, lj = it.q - li * tj, c = it.r;
    const int i = o.i0 + li, j = o.j0 + lj;
    if (i < h && j < w)
      store_f(dx + (((long long)o.b * h + i) * w + j) * C + c,
              acc[it.q * cp + c]);
  }
}

// ---------------------------------------------------------------- dweight

constexpr int kDwThreads = 256;
// The tile's fine rows: ti = kDwFineRows / fh coarse rows.
constexpr int kDwFineRows = 16;
// Units a thread has in flight at once (their labels and lse in registers).
constexpr int kDwUnits = 2;

// Shared memory: the coarse tile (ti+2) x (tj+2) x cp in padded rows, the
// row and column phase tables.
size_t dweight_smem(int ti, int tj, int C, int fh, int fw) {
  return (size_t)(ti + 2) * row_stride(tj + 2, class_stride(C)) * 4
         + (size_t)(fh + fw) * sizeof(PhaseTab);
}

// z of the label's class at one fine pixel: the row blend (ph) of the
// staged rows ra and rb at the pixel's coarse column and at its other
// column tap (side, in floats), then the column blend (self, other), in
// the forward's order. A label outside [0, C) selects no class (z = 0).
__device__ __forceinline__ float label_z(const float* ra, const float* rb,
                                         const PhaseTab& ph, float self,
                                         float other, int side, int lbl,
                                         int C) {
  if (lbl < 0 || lbl >= C) return 0.0f;
  const float mid = ph.self * ra[lbl] + ph.other * rb[lbl];
  const float nb = ph.self * ra[lbl + side] + ph.other * rb[lbl + side];
  return self * mid + other * nb;
}

__device__ __forceinline__ float dweight_of(float lse, float z, int lbl,
                                            int ignore_index, float gs) {
  return lbl == ignore_index ? 0.0f : (lse - z) * gs;
}

// kV consecutive fine pixels' labels and lse, read as one 16-byte vector
// each when kV == 4
template <int kV>
struct FinePixels {
  int lbl[kV];
  float lse[kV];
  __device__ __forceinline__ void load(const int32_t* __restrict__ labels,
                                       const float* __restrict__ lse_g,
                                       long long pix) {
    if constexpr (kV == 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(labels + pix));
      const float4 b = __ldg(reinterpret_cast<const float4*>(lse_g + pix));
      lbl[0] = a.x, lbl[1] = a.y, lbl[2] = a.z, lbl[3] = a.w;
      lse[0] = b.x, lse[1] = b.y, lse[2] = b.z, lse[3] = b.w;
    } else {
      lbl[0] = __ldg(labels + pix);
      lse[0] = __ldg(lse_g + pix);
    }
  }
};

// A unit is 4 fine pixels of one coarse column in one fine row (kF == 4:
// the main paths' factors 4 x 4 and C = 19; labels and lse read and dwt
// written as 16-byte vectors, W = 4w and x0 = 4*j0, so every unit is whole,
// and the host checks the pointers' alignment), or one fine pixel (kF ==
// 0: any factors and C). A thread takes units tid, tid + kDwThreads, ... in
// chunks of kDwUnits; the first chunk's labels and lse are loaded before
// the tile is staged, so the block waits on device memory once.
template <typename T, int kC, int kF>
__global__ void __launch_bounds__(kDwThreads)
ce_dweight_kernel(const float* __restrict__ g, const T* __restrict__ x,
                  const int32_t* __restrict__ labels,
                  const float* __restrict__ lse, float* __restrict__ dwt,
                  int h, int w, int C_arg, int fh_arg, int fw_arg,
                  int ignore_index, float n_total, int ti, int tj) {
  constexpr int kV = kF == 4 ? 4 : 1;   // fine pixels a unit
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int C = kC > 0 ? kC : C_arg;
  const int fh = kF > 0 ? kF : fh_arg, fw = kF > 0 ? kF : fw_arg;
  const int cp = class_stride(C), xc = tj + 2, nrows = ti + 2;
  const int rs = row_stride(xc, cp);
  const TileOrigin o(h, w, ti, tj);
  PhaseTab* rtab = (PhaseTab*)(xs + nrows * rs);
  PhaseTab* ctab = rtab + fh;
  const int H = h * fh, W = w * fw;
  const int y0 = o.i0 * fh, x0 = o.j0 * fw;
  // the tile's fine rows and columns that lie inside the image
  const int nr = min(ti * fh, H - y0), nc = min(tj * fw, W - x0);
  const int upr = nc / kV, n = nr * upr;   // units a fine row, in the tile
  const long long row0 = (long long)o.b * H + y0;   // fine row of tile row 0

  StridedDivmod it(threadIdx.x, kDwThreads, upr);   // (fine row, unit)
  FinePixels<kV> px[kDwUnits];
  int fr[kDwUnits], ur[kDwUnits];
  auto fetch = [&](int base) {
#pragma unroll
    for (int k = 0; k < kDwUnits; ++k, it.next()) {
      fr[k] = it.q;
      ur[k] = it.r;
      if (base + k * kDwThreads + (int)threadIdx.x < n)
        px[k].load(labels, lse, (row0 + it.q) * W + x0 + it.r * kV);
    }
  };
  fetch(0);
  fill_phase_tab(rtab, fh);
  fill_phase_tab(ctab, fw);
  stage_coarse_tile(xs, x, o.b, h, w, C, cp, o.i0 - 1, nrows, o.j0 - 1, xc);
  __pipeline_commit();
  const float gs = __ldg(g) / n_total;
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int base = 0;;) {
#pragma unroll
    for (int k = 0; k < kDwUnits; ++k) {
      if (base + k * kDwThreads + (int)threadIdx.x >= n) continue;
      const int t = fr[k] / fh;
      const PhaseTab ph = rtab[fr[k] - t * fh];
      const long long pix = (row0 + fr[k]) * W + x0 + ur[k] * kV;
      // tile row t is staged row t+1 (its row tap t+1+step); coarse column
      // lj staged column lj+1, its column taps staged columns lj and lj+2
      // (clamped copies at the image's edge)
      const int lj = kF == 4 ? ur[k] : ur[k] / fw;
      const float* ra = xs + (t + 1) * rs + (lj + 1) * cp;
      const float* rb = xs + (t + 1 + ph.step) * rs + (lj + 1) * cp;
      if constexpr (kF == 4) {
        float d[kV];
#pragma unroll
        for (int q = 0; q < kV; ++q) {
          const PhaseW pw = phase_weights(q, kF);   // constants
          d[q] = dweight_of(px[k].lse[q],
                            label_z(ra, rb, ph, pw.self, pw.prev + pw.next,
                                    pw.prev > 0.0f ? -cp : cp, px[k].lbl[q],
                                    C),
                            px[k].lbl[q], ignore_index, gs);
        }
        *reinterpret_cast<float4*>(dwt + pix) =
            make_float4(d[0], d[1], d[2], d[3]);
      } else {
        const PhaseTab pc = ctab[ur[k] - lj * fw];
        dwt[pix] = dweight_of(
            px[k].lse[0], label_z(ra, rb, ph, pc.self, pc.other,
                                  pc.step * cp, px[k].lbl[0], C),
            px[k].lbl[0], ignore_index, gs);
      }
    }
    base += kDwUnits * kDwThreads;
    if (base >= n) break;
    fetch(base);
  }
}

// ------------------------------------------------------------------- host

Tile fwd_tile(int h, int w, int C, int fh, int fw) {
  return pick_tile(fwd_smem, max(1, 8 / fh), max(1, 128 / fw), h, w, C, fh,
                   fw);
}

Tile dx_tile(int h, int w, int C, int fh, int fw) {
  return pick_tile(dx_smem, max(1, 8 / fh), 32, h, w, C, fh, fw);
}

template <typename T>
int fwd(const T* x, const int32_t* labels, const float* wt, float* lse,
        float* partials, unsigned int* done, float* loss, int B, int h, int w,
        int C, int fh, int fw, int ignore_index, cudaStream_t stream) {
  const Tile t = fwd_tile(h, w, C, fh, fw);
  const long long nb = grid_of(t, B, h, w);
  const float n_total = (float)((long long)B * h * fh * w * fw);
  // the repository's 19 classes unroll; any other C takes the loop
  auto kernel = C == 19 ? ce_fwd_kernel<T, 19> : ce_fwd_kernel<T, 0>;
  int err = allow_smem(kernel, t.smem);
  if (err != 0) return err;
  kernel<<<(unsigned)nb, kThreads, t.smem, stream>>>(
      x, labels, wt, lse, partials, done, loss, h, w, C, fh, fw,
      ignore_index, n_total, t.ti, t.tj);
  return (int)cudaGetLastError();
}

template <typename T>
int dx(const float* g, const T* x, const int32_t* labels, const float* wt,
       const float* lse, T* out, int B, int h, int w, int C, int fh, int fw,
       int ignore_index, cudaStream_t stream) {
  const Tile t = dx_tile(h, w, C, fh, fw);
  const float n_total = (float)((long long)B * h * fh * w * fw);
  int err = allow_smem(ce_dx_kernel<T>, t.smem);
  if (err != 0) return err;
  ce_dx_kernel<T><<<(unsigned)grid_of(t, B, h, w), kThreads, t.smem,
                    stream>>>(g, x, labels, wt, lse, out, h, w, C, fh, fw,
                              ignore_index, n_total, t.ti, t.tj);
  return (int)cudaGetLastError();
}

template <typename T>
int dweight(const float* g, const T* x, const int32_t* labels,
            const float* lse, float* out, int B, int h, int w, int C, int fh,
            int fw, int ignore_index, cudaStream_t stream) {
  const Tile t = pick_tile(dweight_smem, max(1, kDwFineRows / fh),
                           max(1, 128 / fw), h, w, C, fh, fw);
  const float n_total = (float)((long long)B * h * fh * w * fw);
  // the main paths' 19 classes at factor 4 take 4 fine pixels a thread in
  // 16-byte vectors (which need 16-byte aligned labels, lse and output);
  // anything else a thread per fine pixel
  const bool aligned =
      (((uintptr_t)labels | (uintptr_t)lse | (uintptr_t)out) & 15) == 0;
  auto kernel = C == 19 && fh == 4 && fw == 4 && aligned
                    ? ce_dweight_kernel<T, 19, 4>
                    : ce_dweight_kernel<T, 0, 0>;
  int err = allow_smem(kernel, t.smem);
  if (err != 0) return err;
  kernel<<<(unsigned)grid_of(t, B, h, w), kDwThreads, t.smem, stream>>>(
      g, x, labels, lse, out, h, w, C, fh, fw,
      ignore_index, n_total, t.ti, t.tj);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partial sums the forward writes (the size of its
// `partials` scratch buffer) for this geometry.
long long cmda_fused_resize_ce_num_partials(int B, int h, int w, int C,
                                            int fh, int fw) {
  return grid_of(fwd_tile(h, w, C, fh, fw), B, h, w);
}

// x: [B,h,w,C] contiguous (float32 or bfloat16); labels: [B,h*fh,w*fw]
// int32; wt: same shape float32 or null; lse: same shape float32 (written);
// partials: float32 scratch of cmda_fused_resize_ce_num_partials(...);
// done: one uint32 that is 0 before the launch and 0 again after it (the
// kernel's count of finished blocks; one per stream, so launches on one
// stream run in turn); loss: one float32 (written). Returns the launch's
// CUDA error.
int cmda_fused_resize_ce_fwd_f32(const float* x, const int32_t* labels,
                                 const float* wt, float* lse, float* partials,
                                 unsigned int* done, float* loss, int B,
                                 int h, int w, int C, int fh, int fw,
                                 int ignore_index, void* stream) {
  return fwd<float>(x, labels, wt, lse, partials, done, loss, B, h, w, C, fh,
                    fw, ignore_index, (cudaStream_t)stream);
}

int cmda_fused_resize_ce_fwd_bf16(const void* x, const int32_t* labels,
                                  const float* wt, float* lse,
                                  float* partials, unsigned int* done,
                                  float* loss, int B, int h, int w, int C,
                                  int fh, int fw, int ignore_index,
                                  void* stream) {
  return fwd<__nv_bfloat16>((const __nv_bfloat16*)x, labels, wt, lse,
                            partials, done, loss, B, h, w, C, fh, fw,
                            ignore_index, (cudaStream_t)stream);
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

// Fused forward + backward pyramidal Lucas-Kanade on a ragged pyramid pair.
//
// Replaces: zenslam_tpu/ops/lk_pallas.py, function _lk_fb_kernel (entry point
// lk_ragged_pallas). Same per-point semantics:
//   - template: edge-clamped bilinear (2r+3)^2 grid around the start point at
//     each level, each continuous tap coordinate clamped to [0, h-1] x [0, w-1]
//     before interpolating (the Pallas triangle-selector semantics);
//   - central-difference gradients of that grid, 2x2 structure tensor, min-
//     eigenvalue gate; can = ok_in && centre-in-bounds && eig_ok;
//   - a fixed number of Newton steps per level with a per-point convergence
//     latch; a step moves only while the target centre is in bounds (t_ok);
//   - positions and flows in full-resolution units, level scale 1/2^l;
//   - only level 0 decides status (bounds-only finish, or a final residual
//     sample when compute_err);
//   - the backward pass starts at the forward solution with flow -fwd and
//     refines only levels bwd_levels-1 .. 0; ok = fwd && bwd && |fwd+bwd| <= thr;
//   - invalid rows pass through unchanged.
//
// What bounds it on an H100: not bytes. The two bf16 pyramids (~5.6 MB at
// 1024^2, 4 levels) sit in the 50 MB L2. Each point takes about 19 dependent
// rounds (a template per level, then Newton steps that each need the previous
// step's block-reduced flow), and with 512 points only ~4 blocks share an
// SM: the latency of each round's L2 loads, shared-memory reads and
// barriers, hidden by 16 warps an SM, bounds it.
//
// Design: one block of LK_THREADS = 128 threads per point, so the 512 points
// of a frame are resident in one wave on 132 SMs (4 blocks of <= 128
// registers a thread fit an SM). Thread t owns window column t % (2r+1) and
// up to MAXC of its rows (4 at r = 10), whose template values and gradients
// it keeps in registers, so a step computes its column tap once. At each
// level the block stages the source texels the template reads, a (G+2)^2
// footprint (G = 2r+3), and the target texels around the first step's window
// with a margin of LK_MARGIN texels, into shared memory in the level's own
// type, then builds the f32 template grid from there. A Newton step re-stages
// the target patch only when its window's footprint leaves it, so steps read
// shared memory, not L2. Sums are warp shuffles, then one pass through
// double-buffered shared memory that every thread reads in the same order:
// the convergence latch, t_ok and the level gate stay block-uniform, and a
// step needs at most two __syncthreads (one only when it re-stages). The
// sampling arithmetic is the plain version's: clamp the continuous
// coordinate, floor, x1 = min(x0+1, w-1), f32 weights, rows then columns;
// only the address of each texel changes (a patch offset instead of a level
// offset), and each texel converts to f32 as it is read. Texture filtering is
// not used: its 8-bit fractional weights would break the 0.01 px parity. The
// pyramid structs and parameters are __grid_constant__, so the run-time level
// indexes them in the parameter space without a local copy (no stack frame).
//
// Copies: a patch spans whole 16-byte chunks of its rows (8 bf16 or 4 f32
// texels, its columns widened to chunk boundaries), copied by cp.async
// straight into shared memory, both patches of a level in one group, when the
// level's width is a whole number of chunks and its base is 16-byte aligned
// (every level of the main path's 1024^2 pyramids); other levels copy texel by
// texel. Not TMA: the patches are 1-5 KB, the levels are ragged, and TMA fills
// out-of-bounds boxes with zeros where this kernel clamps to the edge.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define LK_MAX_LEVELS 8
#define LK_THREADS 128   // threads per point
#define LK_WARPS (LK_THREADS / 32)
#define LK_MARGIN 4      // texels staged around the target window on each side
#define LK_MAX_CELLS 8   // window rows per thread: radius <= 15 at 128 threads

struct LkPyramid {
  const void* level[LK_MAX_LEVELS];  // row-major (h, w) levels, true size
  int h[LK_MAX_LEVELS];
  int w[LK_MAX_LEVELS];
};

struct LkParams {
  int n_points;
  int levels;
  int radius;
  int iters[LK_MAX_LEVELS];  // Newton steps per level, indexed by level
  float eps;
  float min_eig_threshold;
  float fb_threshold;
  int do_backward;
  int bwd_levels;            // backward refines levels bwd_levels-1 .. 0
  int compute_err;
};

__device__ __forceinline__ float ld(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums N values over the block; every thread gets the same totals. Two
// buffers alternate, so one barrier per call suffices: a buffer is written
// again only two calls later, after every thread has passed the barrier of
// the call in between (and so has read this call's totals).
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, int& phase) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf = red + (phase & 1) * (3 * LK_WARPS);
  ++phase;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = warp_sum(v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) buf[j * LK_WARPS + warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < LK_WARPS; ++q) s += buf[j * LK_WARPS + q];
    v[j] = s;
  }
}

// First and last texel index that taps at x_first .. x_last read along an axis
// of n texels (monotone in x, so the end taps bound every tap between them).
__device__ __forceinline__ int tap_lo(float x, int n) {
  return (int)floorf(fminf(fmaxf(x, 0.0f), (float)(n - 1)));
}
__device__ __forceinline__ int tap_hi(float x, int n) {
  return min(tap_lo(x, n) + 1, n - 1);
}

// Texels of type T in one 16-byte chunk.
template <typename T>
__host__ __device__ constexpr int chunk() {
  return 16 / (int)sizeof(T);
}

// A rectangle of level texels [x0, x0+pw) x [y0, y0+ph), staged as T with row
// stride pw.
template <typename T>
struct Patch {
  T* p;
  int x0, y0, pw, ph;
  __device__ __forceinline__ bool covers(int lx, int hx, int ly, int hy) const {
    return lx >= x0 && hx < x0 + pw && ly >= y0 && hy < y0 + ph;
  }
  // Texels [lx, hx] x [ly, hy] of a level of width w, the columns widened to
  // whole chunks (cut at w).
  __device__ __forceinline__ void set(int lx, int hx, int ly, int hy, int w) {
    constexpr int E = chunk<T>();
    x0 = lx & ~(E - 1);
    pw = min((hx + E) & ~(E - 1), w) - x0;
    y0 = ly;
    ph = hy - ly + 1;
  }
};

// Columns a patch of n texels a row may span once widened to chunks.
template <typename T>
__host__ __device__ constexpr int patch_cols(int n) {
  return (n + chunk<T>() - 1) / chunk<T>() * chunk<T>() + chunk<T>();
}

__device__ __forceinline__ void copy16_async(void* dst_shared, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst_shared)), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Stages patch A from image ia and patch B from ib (B.ph may be 0), both on
// one level of width w. With vec (w a whole number of chunks, both images
// 16-byte aligned) each thread issues cp.async copies of whole chunks of both
// patches and waits for them once, so both patches cost one L2 round trip;
// otherwise it copies texel by texel. No barrier: the caller synchronises
// before reading.
template <typename T>
__device__ __forceinline__ void stage(const Patch<T>& A, const T* ia, const Patch<T>& B,
                                      const T* ib, int w, bool vec) {
  const int E = vec ? chunk<T>() : 1;
  const int ca = A.pw / E, cb = B.pw / E;  // copies a row
  const int na = A.ph * ca, n = na + B.ph * cb;
  for (int e = threadIdx.x; e < n; e += LK_THREADS) {
    const bool in_a = e < na;
    const int k = in_a ? e : e - na, c = in_a ? ca : cb;
    const int r = k / c, j = (k - r * c) * E;
    T* dst = in_a ? A.p + r * A.pw + j : B.p + r * B.pw + j;
    const T* src = in_a ? ia + (A.y0 + r) * w + A.x0 + j : ib + (B.y0 + r) * w + B.x0 + j;
    if (vec)
      copy16_async(dst, src);
    else
      *dst = *src;
  }
  if (vec) copies_wait();
}

// Bilinear sample at a continuous coordinate (x, y) clamped into the (h, w)
// level, read from a patch that covers its texels, in two parts: the column
// part (shared by a thread's cells, which lie in one column) and the row
// part. Rows are interpolated first, then columns (the order of the Pallas
// R @ T @ C product), with the plain version's arithmetic.
struct ColTap {
  int c0, c1;
  float ax;
};
template <typename T>
__device__ __forceinline__ ColTap col_tap(const Patch<T>& P, int w, float x) {
  x = fminf(fmaxf(x, 0.0f), (float)(w - 1));
  const float xf = floorf(x);
  const int x0 = (int)xf, x1 = min(x0 + 1, w - 1);
  return ColTap{x0 - P.x0, x1 - P.x0, x - xf};
}
template <typename T>
__device__ __forceinline__ float sample_row(const Patch<T>& P, int h, const ColTap& t, float y) {
  y = fminf(fmaxf(y, 0.0f), (float)(h - 1));
  const float yf = floorf(y);
  const int y0 = (int)yf, y1 = min(y0 + 1, h - 1);
  const float ay = y - yf;
  const T* r0 = P.p + (y0 - P.y0) * P.pw;
  const T* r1 = P.p + (y1 - P.y0) * P.pw;
  const float m0 = (1.0f - ay) * ld(r0, t.c0) + ay * ld(r1, t.c0);
  const float m1 = (1.0f - ay) * ld(r0, t.c1) + ay * ld(r1, t.c1);
  return (1.0f - t.ax) * m0 + t.ax * m1;
}

__device__ __forceinline__ bool centre_in(float px, float py, int h, int w) {
  return (px >= 1.0f) && (py >= 1.0f) && (px <= (float)w - 2.0f) && (py <= (float)h - 2.0f);
}

template <typename T>
struct Smem {
  Patch<T> tpl;  // source texels of the template grid, (G+2)^2
  Patch<T> tgt;  // target texels around the window, (G+1+2*LK_MARGIN)^2
  float* S;      // template grid, G^2
  float* red;    // block_sum buffers, 2 x 3 x LK_WARPS
  int phase;
};

// Byte offsets of the template grid and the target patch in dynamic shared
// memory, and its size, for radius r (the template patch comes first).
template <typename T>
struct SmemLayout {
  int s_off, tgt_off, bytes;
  __host__ __device__ explicit SmemLayout(int r) {
    const int G = 2 * r + 3, side = G + 1 + 2 * LK_MARGIN;
    s_off = ((G + 2) * patch_cols<T>(G + 2) * (int)sizeof(T) + 15) & ~15;
    tgt_off = s_off + ((G * G * (int)sizeof(float) + 15) & ~15);
    bytes = tgt_off + side * patch_cols<T>(side) * (int)sizeof(T);
  }
};

// Texels that the window at offset (ox, oy) can read: taps at 1 + o .. win + o
// lie in [o, o + win + 1] (f32 rounding is monotone), so after clamping they
// read texels floor(o) .. floor(o) + win + 2. A superset of the exact
// footprint for the price of one floor per axis.
struct Span {
  int lx, hx, ly, hy;
};
__device__ __forceinline__ void axis_span(float o, int win, int n, int& lo, int& hi) {
  const int f = (int)floorf(fminf(fmaxf(o, -1.0e6f), 1.0e6f));
  lo = min(max(f, 0), n - 1);
  hi = min(min(max(f + win + 1, 0), n - 1) + 1, n - 1);
}
__device__ __forceinline__ Span window_span(int h, int w, int win, float ox, float oy) {
  Span s;
  axis_span(ox, win, w, s.lx, s.hx);
  axis_span(oy, win, h, s.ly, s.hy);
  return s;
}
template <typename T>
__device__ __forceinline__ void set_target(Patch<T>& P, const Span& s, int h, int w) {
  P.set(max(s.lx - LK_MARGIN, 0), min(s.hx + LK_MARGIN, w - 1), max(s.ly - LK_MARGIN, 0),
        min(s.hy + LK_MARGIN, h - 1), w);
}

// Keeps the target patch if it covers the window at (ox, oy), else re-stages
// it around the window with the margin and synchronises.
template <typename T>
__device__ __forceinline__ void ensure_target(Smem<T>& sm, const T* dimg, int h, int w,
                                              int win, float ox, float oy, bool vec) {
  const Span s = window_span(h, w, win, ox, oy);
  if (sm.tgt.covers(s.lx, s.hx, s.ly, s.hy)) return;
  set_target(sm.tgt, s, h, w);
  Patch<T> none = sm.tpl;
  none.ph = 0;
  stage(sm.tgt, dimg, none, dimg, w, vec);
  __syncthreads();
}

// One coarse-to-fine track of one point (one block) from src to dst over
// levels top .. 0. (fx, fy) is the flow in full-resolution units, updated.
template <typename T, int MAXC>
__device__ __forceinline__ void track(const LkPyramid& src, const LkPyramid& dst,
                                      const LkParams& p, float sx, float sy, float& fx,
                                      float& fy, bool ok_in, int top, bool want_err,
                                      Smem<T>& sm, bool& ok_out, float& err_out) {
  const int r = p.radius;
  const int G = 2 * r + 3;
  const int win = 2 * r + 1;
  const float n_win = (float)(win * win);
  ok_out = ok_in;
  err_out = 0.0f;
  // this thread's window cells: column tb, rows tg, tg + ng, ... (ng groups
  // of win threads; a thread of no group, tg >= ng, owns no cell)
  const int ng = LK_THREADS / win;
  const int tb = threadIdx.x % win;
  const int tg = threadIdx.x / win < ng ? threadIdx.x / win : win;
  // the same for the template grid: column tgj, rows tgi, tgi + ngg, ...
  const int ngg = LK_THREADS / G;
  const int tgj = threadIdx.x / G < ngg ? threadIdx.x % G : G;
  const int tgi = threadIdx.x / G;
  float I[MAXC], GX[MAXC], GY[MAXC];
  for (int l = top; l >= 0; --l) {
    // a row that is not ok changes nothing above level 0, and at level 0 only
    // its residual (err) is read
    if (!ok_in && !(l == 0 && want_err)) continue;
    const int h = src.h[l], w = src.w[l];
    const T* simg = (const T*)src.level[l];
    const T* dimg = (const T*)dst.level[l];
    const float scale = __int_as_float((127 - l) << 23);  // 1 / 2^l, exactly
    const float up = (float)(1 << l);                     // x / scale == x * up
    const float px = sx * scale, py = sy * scale;
    const bool lvl_ok = centre_in(px, py, h, w);
    const float offx = (px - (float)r) - 1.0f, offy = (py - (float)r) - 1.0f;
    const bool vec = w % chunk<T>() == 0 && ((uintptr_t)simg | (uintptr_t)dimg) % 16 == 0;
    // template texels, and the target texels around the first step's window,
    // in one batch (the previous level's reads ended at a barrier)
    sm.tpl.set(tap_lo(offx, w), tap_hi((float)(G - 1) + offx, w), tap_lo(offy, h),
               tap_hi((float)(G - 1) + offy, h), w);
    {
      const float tx = (sx + fx) * scale, ty = (sy + fy) * scale;
      set_target(sm.tgt, window_span(h, w, win, (tx - (float)r) - 1.0f, (ty - (float)r) - 1.0f),
                 h, w);
    }
    stage(sm.tpl, simg, sm.tgt, dimg, w, vec);
    __syncthreads();
    if (tgj < G) {  // grid column tgj, rows tgi, tgi + ngg, ...
      const ColTap t = col_tap(sm.tpl, w, (float)tgj + offx);
      for (int gi = tgi; gi < G; gi += ngg)
        sm.S[gi * G + tgj] = sample_row(sm.tpl, h, t, (float)gi + offy);
    }
    __syncthreads();
    float st[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int a = tg + j * ng, b = tb;
      I[j] = GX[j] = GY[j] = 0.0f;
      if (a < win) {
        const float* S = sm.S;
        const float gx = (S[(a + 1) * G + b + 2] - S[(a + 1) * G + b]) * 0.5f;
        const float gy = (S[(a + 2) * G + b + 1] - S[a * G + b + 1]) * 0.5f;
        I[j] = S[(a + 1) * G + b + 1];
        GX[j] = gx;
        GY[j] = gy;
        st[0] += gx * gx;
        st[1] += gx * gy;
        st[2] += gy * gy;
      }
    }
    block_sum<3>(st, sm.red, sm.phase);
    const float gxx = st[0], gxy = st[1], gyy = st[2];
    const float det = gxx * gyy - gxy * gxy;
    const float tr = gxx + gyy;
    const float min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    const bool eig_ok = (min_eig / n_win) > p.min_eig_threshold;
    const float det_s = fabsf(det) < 1e-12f ? 1e-12f : det;
    const float iG00 = gyy / det_s, iG01 = -gxy / det_s, iG11 = gxx / det_s;
    const bool can = ok_in && lvl_ok && eig_ok;

    if (can) {
      bool conv = false;
      for (int it = 0; it < p.iters[l] && !conv; ++it) {
        const float tx = (sx + fx) * scale, ty = (sy + fy) * scale;
        const bool t_ok = centre_in(tx, ty, h, w);
        const float ox = (tx - (float)r) - 1.0f, oy = (ty - (float)r) - 1.0f;
        ensure_target(sm, dimg, h, w, win, ox, oy, vec);
        float bb[2] = {0.0f, 0.0f};
        const ColTap t = col_tap(sm.tgt, w, (float)(tb + 1) + ox);
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          const int a = tg + j * ng;
          if (a < win) {
            const float e = I[j] - sample_row(sm.tgt, h, t, (float)(a + 1) + oy);
            bb[0] += e * GX[j];
            bb[1] += e * GY[j];
          }
        }
        block_sum<2>(bb, sm.red, sm.phase);
        const float bx = bb[0], by = bb[1];
        const float dx = iG00 * bx + iG01 * by;
        const float dy = iG01 * bx + iG11 * by;
        if (t_ok) {
          fx += dx * up;
          fy += dy * up;
        }
        conv = (dx * dx + dy * dy < p.eps * p.eps) || !t_ok;
      }
    }
    if (l == 0) {
      const float qx = sx + fx, qy = sy + fy;
      const bool pos_ok = centre_in(qx, qy, h, w);
      if (want_err) {
        const float ox = (qx - (float)r) - 1.0f, oy = (qy - (float)r) - 1.0f;
        ensure_target(sm, dimg, h, w, win, ox, oy, vec);
        float s[1] = {0.0f};
        const ColTap t = col_tap(sm.tgt, w, (float)(tb + 1) + ox);
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          const int a = tg + j * ng;
          if (a < win) s[0] += fabsf(I[j] - sample_row(sm.tgt, h, t, (float)(a + 1) + oy));
        }
        block_sum<1>(s, sm.red, sm.phase);
        err_out = s[0] / n_win;
      }
      ok_out = can && pos_ok;
    }
  }
}

// At most 4 cells a thread (radius <= 10 at 128 threads) the kernel is held
// to 128 registers, so 4 blocks fit on an SM and 512 points run in one wave.
template <typename T, int MAXC>
__global__ void __launch_bounds__(LK_THREADS, MAXC <= 4 ? 4 : 1)
lk_fb_kernel(const __grid_constant__ LkPyramid prev, const __grid_constant__ LkPyramid next,
             const float* __restrict__ pts, const float* __restrict__ init,
             const uint8_t* __restrict__ valid, const __grid_constant__ LkParams p,
             float* __restrict__ out_xy, uint8_t* __restrict__ out_ok,
             float* __restrict__ out_err) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * 3 * LK_WARPS];
  const int i = blockIdx.x;
  const SmemLayout<T> lay(p.radius);
  Smem<T> sm;
  sm.tpl.p = (T*)smem;
  sm.S = (float*)(smem + lay.s_off);
  sm.tgt.p = (T*)(smem + lay.tgt_off);
  sm.red = red;
  sm.phase = 0;

  const float x0 = pts[2 * i], y0 = pts[2 * i + 1];
  const bool v = valid[i] != 0;
  float fx = init[2 * i] - x0, fy = init[2 * i + 1] - y0;
  bool okf;
  float err;
  track<T, MAXC>(prev, next, p, x0, y0, fx, fy, v, p.levels - 1, p.compute_err != 0, sm,
                 okf, err);
  bool ok_out = okf;
  if (p.do_backward) {
    float bx = -fx, by = -fy;
    bool okb;
    float unused;
    const int bl = p.bwd_levels < p.levels ? p.bwd_levels : p.levels;
    track<T, MAXC>(next, prev, p, x0 + fx, y0 + fy, bx, by, okf, bl - 1, false, sm, okb,
                   unused);
    const float ex = fx + bx, ey = fy + by;
    ok_out = okf && okb && (ex * ex + ey * ey <= p.fb_threshold * p.fb_threshold);
  }
  if (threadIdx.x == 0) {
    out_xy[2 * i] = v ? x0 + fx : x0;
    out_xy[2 * i + 1] = v ? y0 + fy : y0;
    out_ok[i] = (ok_out && v) ? 1 : 0;
    out_err[i] = err;
  }
}

template <typename T, int MAXC>
static int launch_cells(const LkPyramid& prev, const LkPyramid& next, const float* pts,
                        const float* init, const uint8_t* valid, const LkParams& p,
                        float* out_xy, uint8_t* out_ok, float* out_err, cudaStream_t stream) {
  const size_t smem = (size_t)SmemLayout<T>(p.radius).bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lk_fb_kernel<T, MAXC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lk_fb_kernel<T, MAXC><<<p.n_points, LK_THREADS, smem, stream>>>(
      prev, next, pts, init, valid, p, out_xy, out_ok, out_err);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const LkPyramid& prev, const LkPyramid& next, const float* pts,
                  const float* init, const uint8_t* valid, const LkParams& p,
                  float* out_xy, uint8_t* out_ok, float* out_err, cudaStream_t stream) {
  // a thread owns one window column and up to MAXC of its rows (and one
  // template grid column)
  const int win = 2 * p.radius + 1;
  if (p.radius < 0 || win + 2 > LK_THREADS) return (int)cudaErrorInvalidValue;
  const int ng = LK_THREADS / win, cells = (win + ng - 1) / ng;
  if (cells > LK_MAX_CELLS) return (int)cudaErrorInvalidValue;
  if (cells <= 2)
    return launch_cells<T, 2>(prev, next, pts, init, valid, p, out_xy, out_ok, out_err, stream);
  if (cells <= 4)
    return launch_cells<T, 4>(prev, next, pts, init, valid, p, out_xy, out_ok, out_err, stream);
  return launch_cells<T, 8>(prev, next, pts, init, valid, p, out_xy, out_ok, out_err, stream);
}

extern "C" int lk_fb_launch(LkPyramid prev, LkPyramid next, const float* pts,
                            const float* init, const uint8_t* valid, LkParams p,
                            int is_bf16, float* out_xy, uint8_t* out_ok, float* out_err,
                            void* stream) {
  if (p.n_points <= 0) return 0;
  if (p.levels < 1 || p.levels > LK_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(prev, next, pts, init, valid, p, out_xy, out_ok, out_err, s);
  return launch<float>(prev, next, pts, init, valid, p, out_xy, out_ok, out_err, s);
}

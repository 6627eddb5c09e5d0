// ORB orientation + steered BRIEF, one block per keypoint.
//
// Replaces: zenslam_tpu/ops/orb_pallas.py, functions _orb_kernel / _orb_block
// (entry points orb_pallas, orb_descriptors_pallas). Same per-keypoint
// semantics, on the pre-smoothed bf16 image:
//   - intensity-centroid moments m10, m01 over the 31x31 square centred at the
//     rounded keypoint (round half to even), zero outside the image;
//   - c = m10/|m|, s = m01/|m| (c = 1, s = 0 when |m| <= 1e-12);
//   - 256 pattern pairs rotated by (c, s), each endpoint sampled at the nearest
//     pixel (round half to even, then clip into the image);
//   - bit = v1 < v2 && valid, packed LSB first: word w, bit j = pair 32w + j.
// With a `needs` mask, a keypoint whose row is not needed is skipped and its
// outputs are left undefined (the caller merges them away).
//
// What bounds it on an H100: not bytes (a 2 MB bf16 image in, 16 KB out).
// Each keypoint reads 961 moment taps and 512 scattered pattern texels, all
// from one small neighbourhood of the image; the latency of those reads and
// of the reduction between them bounds it.
//
// Design: one block of ORB_THREADS threads per keypoint stages the 43x43
// texels around the rounded centre (xi, yi) into shared memory as f32, with
// coordinates clamped into the image: each thread issues all its loads before
// its first store (the pattern rows are loaded before them, so the round
// trips overlap), so staging costs about one L2 round trip. 43 = 2*21 + 1:
// the pattern is clipped to +-14, so a rotated endpoint lies within
// 14*sqrt(2) of the centre and |rint(q) - xi| <= ceil(14*sqrt(2) + 0.5) = 21.
// The moments accumulate from the loaded registers, masked to the 31x31
// square and by the in-image test on the unclamped tap ("zero outside the
// image"), and reduce by warp shuffles and one shared-memory pass that every
// thread reads in the same order; its barrier also publishes the patch, so
// the kernel has one. A pattern endpoint reads
// patch[rint(qy) - (yi-21)][rint(qx) - (xi-21)], which by construction is
// img[clip(rint(q))]. Warp w evaluates words w*8/ORB_WARPS .., lane j pair
// 32*word + j, and __ballot_sync turns each group of 32 comparisons into the
// packed word (lane j = bit j). Coordinates use explicitly rounded
// multiply/add so they are not contracted into FMAs and round exactly as the
// plain version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define ORB_THREADS 128
#define ORB_WARPS (ORB_THREADS / 32)
#define ORB_WORDS_PER_WARP (8 / ORB_WARPS)  // 8 descriptor words over the warps
static_assert(ORB_WARPS <= 8 && 8 % ORB_WARPS == 0, "ORB_WARPS must divide 8");
#define ORB_R 15             // moment window radius (31x31)
#define ORB_PR 21            // patch radius: every pattern endpoint's pixel
#define ORB_PS (2 * ORB_PR + 1)
#define ORB_PER_THREAD ((ORB_PS * ORB_PS + ORB_THREADS - 1) / ORB_THREADS)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rint(q) as an integer, clamped to +-1e9 (so NaN and huge coordinates stay
// defined), then as a patch index relative to the centre c; the final clamp
// only matters where every patch texel is the same clipped edge texel.
__device__ __forceinline__ int patch_index(float q, int c) {
  const float r = fminf(fmaxf(rintf(q), -1.0e9f), 1.0e9f);
  const int j = (int)r - c + ORB_PR;
  return j < 0 ? 0 : (j > ORB_PS - 1 ? ORB_PS - 1 : j);
}

__global__ void __launch_bounds__(ORB_THREADS)
orb_kernel(const __nv_bfloat16* __restrict__ img, int H, int W,
           const float* __restrict__ xy, const uint8_t* __restrict__ valid,
           const uint8_t* __restrict__ needs, const float* __restrict__ pattern,
           int32_t* __restrict__ out_words, float* __restrict__ out_cs) {
  __shared__ float P[ORB_PS * ORB_PS];
  __shared__ float red[2 * ORB_WARPS];
  const int i = blockIdx.x;
  if (needs != nullptr && needs[i] == 0) return;  // row not needed: skipped
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  float pat[ORB_WORDS_PER_WARP][4];
#pragma unroll
  for (int q = 0; q < ORB_WORDS_PER_WARP; ++q) {
    const float* pp = pattern + 4 * (32 * (warp * ORB_WORDS_PER_WARP + q) + lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) pat[q][k] = pp[k];
  }

  const float xc = xy[2 * i], yc = xy[2 * i + 1];
  const float xr = fminf(fmaxf(rintf(xc), -1.0e9f), 1.0e9f);
  const float yr = fminf(fmaxf(rintf(yc), -1.0e9f), 1.0e9f);
  const int xi = (int)xr, yi = (int)yr;

  // patch texels, all of a thread's loads in flight before its first store;
  // the moments accumulate from the same registers
  float v[ORB_PER_THREAD];
#pragma unroll
  for (int k = 0; k < ORB_PER_THREAD; ++k) {
    const int e = tid + k * ORB_THREADS;
    const int r = e / ORB_PS, c = e - r * ORB_PS;
    const int gy = min(max(yi - ORB_PR + r, 0), H - 1);
    const int gx = min(max(xi - ORB_PR + c, 0), W - 1);
    v[k] = e < ORB_PS * ORB_PS ? __bfloat162float(img[(size_t)gy * W + gx]) : 0.0f;
  }
  float m10 = 0.0f, m01 = 0.0f;
#pragma unroll
  for (int k = 0; k < ORB_PER_THREAD; ++k) {
    const int e = tid + k * ORB_THREADS;
    if (e < ORB_PS * ORB_PS) {
      P[e] = v[k];
      const int dy = e / ORB_PS - ORB_PR, dx = e % ORB_PS - ORB_PR;
      const int yy = yi + dy, xx = xi + dx;
      if (abs(dy) <= ORB_R && abs(dx) <= ORB_R && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        m10 += (float)dx * v[k];
        m01 += (float)dy * v[k];
      }
    }
  }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  if (lane == 0) {
    red[warp] = m10;
    red[ORB_WARPS + warp] = m01;
  }
  __syncthreads();  // the patch and the moment partial sums are in place
  m10 = 0.0f;
  m01 = 0.0f;
#pragma unroll
  for (int q = 0; q < ORB_WARPS; ++q) {
    m10 += red[q];
    m01 += red[ORB_WARPS + q];
  }
  const float nrm = sqrtf(m10 * m10 + m01 * m01);
  const bool good = nrm > 1e-12f;
  const float cs = good ? m10 / fmaxf(nrm, 1e-12f) : 1.0f;
  const float sn = good ? m01 / fmaxf(nrm, 1e-12f) : 0.0f;
  const bool ok = valid[i] != 0;

#pragma unroll
  for (int q = 0; q < ORB_WORDS_PER_WARP; ++q) {
    const float* pp = pat[q];
    // qx = (xc + px*c) - py*s ; qy = (yc + px*s) + py*c
    const float qx1 = __fsub_rn(__fadd_rn(xc, __fmul_rn(pp[0], cs)), __fmul_rn(pp[1], sn));
    const float qy1 = __fadd_rn(__fadd_rn(yc, __fmul_rn(pp[0], sn)), __fmul_rn(pp[1], cs));
    const float qx2 = __fsub_rn(__fadd_rn(xc, __fmul_rn(pp[2], cs)), __fmul_rn(pp[3], sn));
    const float qy2 = __fadd_rn(__fadd_rn(yc, __fmul_rn(pp[2], sn)), __fmul_rn(pp[3], cs));
    const float v1 = P[patch_index(qy1, yi) * ORB_PS + patch_index(qx1, xi)];
    const float v2 = P[patch_index(qy2, yi) * ORB_PS + patch_index(qx2, xi)];
    const unsigned word = __ballot_sync(0xffffffffu, ok && (v1 < v2));
    if (lane == 0) out_words[8 * i + warp * ORB_WORDS_PER_WARP + q] = (int32_t)word;
  }
  if (tid == 0) {
    out_cs[2 * i] = cs;
    out_cs[2 * i + 1] = sn;
  }
}

extern "C" int orb_launch(const void* img, int H, int W, const float* xy,
                          const uint8_t* valid, const uint8_t* needs,
                          const float* pattern, int n, int32_t* out_words,
                          float* out_cs, void* stream) {
  if (n <= 0) return 0;
  orb_kernel<<<n, ORB_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)img, H, W, xy, valid, needs, pattern, out_words, out_cs);
  return (int)cudaGetLastError();
}

// FAST-9/16 corner score, one thread per output pixel (kernel K3).
//
// Replaces srrg2_proslam_tpu/ops/fast_pallas.py::fast_scores_pallas.
// score(y, x) = max over the 16 cyclic 9-arcs of the arc minimum of
// (ring - centre), or of (centre - ring), whichever is larger; a score not
// above the threshold becomes 0.  Outside the image the ring reads zeros,
// as the TPU kernel's zero-padded canvas does.
//
// Bound on the card: memory.  Per pixel the kernel reads one float and
// writes one (the 16 ring samples come from a shared-memory tile with a
// 3-px halo, so each input element is read from device memory ~1.4 times);
// the ~100 min/max per pixel are far below the ALU rate.  The arc minima
// use the identity arcmin(centre - ring) = -arcmax(ring - centre), so only
// one set of differences is formed; min, max, negation and subtraction are
// exact, so the result is bit-identical to the plain PyTorch version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kPad = 3;
constexpr int kTW = kBX + 2 * kPad;
constexpr int kTH = kBY + 2 * kPad;

__global__ void __launch_bounds__(kBX * kBY)
fast_scores_kernel(const float* __restrict__ img, float* __restrict__ out,
                   int H, int W, float threshold) {
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  __shared__ float tile[kTH][kTW];

  const int b = blockIdx.z;
  const float* im = img + (size_t)b * H * W;
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < kTH * kTW; i += kBX * kBY) {
    const int ty = i / kTW, tx = i % kTW;
    const int gy = y0 + ty - kPad, gx = x0 + tx - kPad;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? im[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + kPad, cx = threadIdx.x + kPad;
  const float c = tile[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[cy + kDy[k]][cx + kDx[k]] - c;

  float best_min = -INFINITY;  // max over arcs of arcmin(ring - centre)
  float least_max = INFINITY;  // min over arcs of arcmax(ring - centre)
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mn = d[s], mx = d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      mn = fminf(mn, d[(s + j) & 15]);
      mx = fmaxf(mx, d[(s + j) & 15]);
    }
    best_min = fmaxf(best_min, mn);
    least_max = fminf(least_max, mx);
  }
  const float score = fmaxf(best_min, -least_max);
  out[(size_t)b * H * W + (size_t)y * W + x] = score > threshold ? score : 0.0f;
}

}  // namespace

extern "C" int fast_scores_launch(const float* img, float* out, int B, int H,
                                  int W, float threshold, cudaStream_t stream) {
  dim3 block(kBX, kBY);
  dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, B);
  fast_scores_kernel<<<grid, block, 0, stream>>>(img, out, H, W, threshold);
  return (int)cudaGetLastError();
}

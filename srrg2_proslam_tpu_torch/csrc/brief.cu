// Dense BRIEF-256 bitplanes, one thread per pixel (kernel K1).
//
// Replaces srrg2_proslam_tpu/ops/brief_pallas.py::brief_bitplanes.
// Bit k of pixel (y, x) is smooth[y + p_k] < smooth[y + q_k] for the 256
// sampling pairs, packed LSB-first into 8 int32 words (pair k -> word k/32,
// bit k%32); out is [B, 8, H, W].  Outside the image the samples read
// zeros, as the TPU kernel's zero-padded canvas does.
//
// Bound on the card: shared-memory loads.  Each pixel does 512 reads from
// a shared-memory tile with a 15-px halo (the block's 32x8 pixels need a
// 62x38 tile), against 4 bytes read and 32 bytes written in device memory.
// The pair table arrives as a device tensor and is staged once per block
// as tile offsets, so each comparison is two shared loads at a constant
// per-pair offset from the thread's centre: threads of a warp read
// consecutive words (no bank conflicts) and the pair offsets are
// broadcasts.  Comparisons are exact, so the bits equal the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kPad = 15;
constexpr int kTW = kBX + 2 * kPad;
constexpr int kTH = kBY + 2 * kPad;
constexpr int kPairs = 256;
constexpr int kWords = 8;

__global__ void __launch_bounds__(kBX * kBY)
brief_bitplanes_kernel(const float* __restrict__ smooth,
                       const int* __restrict__ pairs,  // [256, 2, 2] (dy, dx)
                       int* __restrict__ out, int H, int W) {
  __shared__ float tile[kTH * kTW];
  __shared__ int p_off[kPairs];
  __shared__ int q_off[kPairs];

  const int b = blockIdx.z;
  const float* im = smooth + (size_t)b * H * W;
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int k = tid; k < kPairs; k += kBX * kBY) {
    p_off[k] = pairs[4 * k + 0] * kTW + pairs[4 * k + 1];
    q_off[k] = pairs[4 * k + 2] * kTW + pairs[4 * k + 3];
  }
  for (int i = tid; i < kTH * kTW; i += kBX * kBY) {
    const int ty = i / kTW, tx = i % kTW;
    const int gy = y0 + ty - kPad, gx = x0 + tx - kPad;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? im[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* centre = tile + (threadIdx.y + kPad) * kTW + threadIdx.x + kPad;
  const size_t plane = (size_t)H * W;
  int* dst = out + (size_t)b * kWords * plane + (size_t)y * W + x;
#pragma unroll 1
  for (int w = 0; w < kWords; ++w) {
    unsigned int acc = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int k = w * 32 + j;
      acc |= (unsigned int)(centre[p_off[k]] < centre[q_off[k]]) << j;
    }
    dst[w * plane] = (int)acc;
  }
}

}  // namespace

extern "C" int brief_bitplanes_launch(const float* smooth, const int* pairs,
                                      int* out, int B, int H, int W,
                                      cudaStream_t stream) {
  dim3 block(kBX, kBY);
  dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, B);
  brief_bitplanes_kernel<<<grid, block, 0, stream>>>(smooth, pairs, out, H, W);
  return (int)cudaGetLastError();
}

// BRIEF-256 descriptors at the keypoints, one warp per keypoint (kernel K1).
//
// Replaces srrg2_proslam_tpu/ops/brief_pallas.py::brief_bitplanes together
// with its consumer descriptors_from_planes, as the JAX frontend uses them
// (ops/features.py::extract_features_batch): entry [b, n, k] of the
// [B, N, 256] int8 output is +1 if smooth[y + p_k] < smooth[y + q_k] at
// keypoint (y, x) = (y[b, n], x[b, n]), else -1, and all 256 entries are -1
// where valid[b, n] is false.  Samples outside the image read zeros, as the
// TPU kernel's zero-padded canvas does (the frontend's BORDER clip keeps
// every sample inside; the guard is cheap).
//
// The TPU kernel computes the bits at every pixel because scalar gathers
// are slow there; on this card a gather through L1 is cheap, so the kernel
// evaluates only the keypoints the frontend asks for (2 x 1152 on KITTI
// against 2 x 466,616 pixels).  Bound on the card: launch latency.  The
// work is 512 sample loads per keypoint from a 31x31 patch of a few KB,
// which stays in L1 (__ldg), and 256 bytes written per keypoint.  8 warps,
// i.e. 8 keypoints, per block: 288 blocks for the KITTI pair, more than the
// 132 SMs.  Lane l evaluates pairs l, l+32, ..., l+224, reading its own
// (p, q) offsets from the pair table staged once per block in shared
// memory (consecutive lanes read consecutive 16-byte entries; __constant__
// memory would serialise the 32 different addresses), and writes its 8
// bytes as 8 warp-wide stores of 32 consecutive bytes.  Comparisons only:
// the bytes equal the plain version's exactly.
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kPerLane = kPairs / 32;
static_assert(kThreads == kPairs, "one thread stages one pair");

__device__ __forceinline__ float sample(const float* im, long long y,
                                        long long x, int H, int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(im + y * W + x) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
brief_descriptors_kernel(const float* __restrict__ smooth,  // [B, H, W]
                         const int4* __restrict__ pairs,    // [256] (pdy, pdx, qdy, qdx)
                         const long long* __restrict__ ys,  // [B, N]
                         const long long* __restrict__ xs,  // [B, N]
                         const unsigned char* __restrict__ valid,  // [B, N]
                         signed char* __restrict__ out,     // [B, N, 256]
                         int BN, int N, int H, int W) {
  __shared__ int4 s_pairs[kPairs];
  s_pairs[threadIdx.x] = pairs[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= BN) return;
  signed char* dst = out + (size_t)g * kPairs + lane;
  if (!valid[g]) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) dst[32 * j] = -1;
    return;
  }
  const float* im = smooth + (size_t)(g / N) * H * W;
  const long long y = ys[g], x = xs[g];
  float a[kPerLane], b[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int4 pq = s_pairs[lane + 32 * j];
    a[j] = sample(im, y + pq.x, x + pq.y, H, W);
    b[j] = sample(im, y + pq.z, x + pq.w, H, W);
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) dst[32 * j] = a[j] < b[j] ? 1 : -1;
}

}  // namespace

extern "C" int brief_descriptors_launch(const float* smooth, const int* pairs,
                                        const long long* ys, const long long* xs,
                                        const unsigned char* valid,
                                        signed char* out, int B, int N, int H,
                                        int W, cudaStream_t stream) {
  const int BN = B * N;
  if (BN == 0) return (int)cudaSuccess;
  const int blocks = (BN + kWarpsPerBlock - 1) / kWarpsPerBlock;
  brief_descriptors_kernel<<<blocks, kThreads, 0, stream>>>(
      smooth, reinterpret_cast<const int4*>(pairs), ys, xs, valid, out, BN, N,
      H, W);
  return (int)cudaGetLastError();
}

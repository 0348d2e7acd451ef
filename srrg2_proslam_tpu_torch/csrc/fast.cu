// FAST-9/16 corner score with an exact early reject (kernel K3).
//
// Replaces srrg2_proslam_tpu/ops/fast_pallas.py::fast_scores_pallas.
// score(y, x) = max over the 16 cyclic 9-arcs of the arc minimum of
// (ring - centre), or of (centre - ring), whichever is larger; a score not
// above the threshold becomes 0.  Outside the image the ring reads zeros,
// as the TPU kernel's zero-padded canvas does.
//
// The early reject.  Every 9-arc of the 16-ring holds two adjacent compass
// samples (ring indices 0/4, 4/8, 8/12 or 12/0), so a bright score above t
// needs two adjacent compass differences ring - centre > t, and a dark one
// two adjacent centre - ring > t (ring - centre < -t: IEEE subtraction is
// antisymmetric).  A polarity that fails its test scores at most t and
// cannot change the output; where both fail the output is 0.  Min, max,
// subtraction and comparison are exact, so the output equals the plain
// PyTorch version bit for bit.
//
// What bounds it on the card.  Forming all 16 arcs of both polarities for
// every pixel takes ~290 FMNMX per pixel; FMNMX issues at 64 lanes per SM
// and clock, half the FADD rate, so a dense kernel is bound by min/max at
// ~10x the time of its bytes.  This design:
//   A. every pixel: the compass test sets a bright and a dark bit, from
//      the max and the min of each opposite compass pair (4 min/max), 4
//      subtractions and 4 comparisons;
//   B. the bits are compacted into one shared list, bright entries from
//      the front and dark ones from the back (one ballot per warp, row and
//      polarity, one shared atomic per warp and polarity), so every warp of
//      C but one does one polarity and nothing diverges;
//   C. all threads walk the list densely: each entry is one polarity of one
//      pixel, 57 min/max on the raw ring values (the 16 arcs by van Herk
//      blocks, 42, the best arc, 15) and 1 subtraction: fl(x - c) is
//      monotone in x, so min(fl(ring - c)) = fl(min(ring) - c), and the
//      subtraction can follow the arcs exactly;
//   D. the larger set polarity above the threshold, zeros elsewhere, in one
//      coalesced store of the tile.
// On KITTI frame 0 about a fifth of the pixels are candidates, which puts
// the operations below the bytes (one float read, one written per pixel);
// on noise nearly every pixel is one and min/max on the ALU pipe bound it.
// What the card reaches is set by the phases' latency more than by either
// bound: one CTA stages, tests, compacts, scores and stores in turn, and
// CTAs with many candidates finish last.
//
// The input tile is loaded by plain coalesced loads, not TMA: a tensor map
// needs a global row stride that is a multiple of 16 bytes, and a KITTI
// row is 1241 x 4 = 4964 bytes.
//
// Tiles: FAST_TILE_W x FAST_TILE_H output pixels per CTA of FAST_THREADS
// threads, fixed at compile time; scripts/fast_tiles_torch.py times the
// choices.  Of those tried, 32 x 16 with 128 threads was the fastest on
// noise and within 1 % of the fastest on KITTI (PERF.md): small CTAs, many
// resident per SM, let the phases of one overlap those of others.
#include <cuda_runtime.h>
#include <math.h>

#ifndef FAST_TILE_W
#define FAST_TILE_W 32
#endif
#ifndef FAST_TILE_H
#define FAST_TILE_H 16
#endif
#ifndef FAST_THREADS
#define FAST_THREADS 128
#endif

namespace {

constexpr int kTW = FAST_TILE_W;
constexpr int kTH = FAST_TILE_H;
constexpr int kThreads = FAST_THREADS;
constexpr int kPad = 3;
constexpr int kInW = kTW + 2 * kPad;
constexpr int kInH = kTH + 2 * kPad;
constexpr int kIn = kInW * kInH;
constexpr int kLoadIters = (kIn + kThreads - 1) / kThreads;
constexpr int kGroups = kThreads / kTW;   // row groups of the tile
constexpr int kRows = kTH / kGroups;      // consecutive rows per thread
constexpr int kList = 2 * kTW * kTH;      // bright entries from the front, dark from the back
static_assert(kTW % 32 == 0 && kThreads % kTW == 0 && kTH % kGroups == 0,
              "a warp must lie in one row of the tile, the rows split evenly");
static_assert(kTW * kTH <= 65536 && kRows <= 16, "16-bit list entries, 2 bits per row");

// Best arc of the 16 ring values v: kMax = false gives max over the 16
// cyclic 9-arcs of the arc minimum, kMax = true min over the arcs of the
// arc maximum.  Van Herk / Gil-Werman: the doubled ring e[0..23] is cut into
// blocks e[0..8], e[9..17], e[18..]; an arc starting at k is a suffix of
// one block joined to a prefix of the next.  42 min/max for the 16 arcs,
// 15 for the best one.
template <bool kMax>
__device__ __forceinline__ float best_arc(const float (&v)[16]) {
  auto arc = [](float a, float b) { return kMax ? fmaxf(a, b) : fminf(a, b); };
  auto pick = [](float a, float b) { return kMax ? fminf(a, b) : fmaxf(a, b); };
  float s0[9], p1[8], s1[9], p2[6], w[16];
  s0[8] = v[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) s0[i] = arc(v[i], s0[i + 1]);     // e[i..8]
  p1[0] = v[9];
#pragma unroll
  for (int i = 1; i < 8; ++i) p1[i] = arc(p1[i - 1], v[(9 + i) & 15]);  // e[9..9+i]
  s1[8] = v[1];
#pragma unroll
  for (int i = 7; i >= 0; --i) s1[i] = arc(v[(9 + i) & 15], s1[i + 1]);  // e[9+i..17]
  p2[0] = v[2];
#pragma unroll
  for (int i = 1; i < 6; ++i) p2[i] = arc(p2[i - 1], v[2 + i]);  // e[18..18+i]
  w[0] = s0[0];
#pragma unroll
  for (int k = 1; k <= 8; ++k) w[k] = arc(s0[k], p1[k - 1]);
  w[9] = s1[0];
#pragma unroll
  for (int k = 10; k < 16; ++k) w[k] = arc(s1[k - 9], p2[k - 10]);
  // a tree of halvings, each level written out so that every index is a
  // constant and w stays in registers
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = pick(w[k], w[k + 8]);
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = pick(w[k], w[k + 4]);
  w[0] = pick(w[0], w[2]);
  w[1] = pick(w[1], w[3]);
  return pick(w[0], w[1]);
}

__global__ void __launch_bounds__(kThreads)
fast_scores_kernel(const float* __restrict__ img, float* __restrict__ out,
                   int H, int W, float threshold) {
  // ring offsets (dy, dx) in clockwise order, as ops/features.py _FAST_OFFSETS
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  __shared__ float tile[kInH][kInW];
  __shared__ float bright_score[kTH * kTW];
  __shared__ float dark_score[kTH * kTW];
  __shared__ unsigned short list[kList];
  __shared__ int count[2];

  const int b = blockIdx.z;
  const float* im = img + (size_t)b * H * W;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < 2) count[tid] = 0;

  // stage the tile and its 3-px halo, zeros outside the image: all loads
  // in flight before the first store
  float v[kLoadIters];
#pragma unroll
  for (int j = 0; j < kLoadIters; ++j) {
    const int i = tid + j * kThreads;
    const int gy = y0 - kPad + i / kInW, gx = x0 - kPad + i % kInW;
    v[j] = (i < kIn && gy >= 0 && gy < H && gx >= 0 && gx < W)
               ? __ldg(im + (size_t)gy * W + gx) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kLoadIters; ++j) {
    const int i = tid + j * kThreads;
    if (i < kIn) (&tile[0][0])[i] = v[j];
  }
  __syncthreads();

  // A. compass test on this thread's column of kRows pixels
  const int lx = tid % kTW;
  const int ly0 = (tid / kTW) * kRows;
  const int gx = x0 + lx;
  float col[kRows + 2 * kPad];
#pragma unroll
  for (int r = 0; r < kRows + 2 * kPad; ++r) col[r] = tile[ly0 + r][lx + kPad];
  unsigned bits = 0;     // 2 bits per row: bright, dark
  unsigned ballot_b[kRows], ballot_d[kRows];
  int total_b = 0, total_d = 0;
  const float t = threshold;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float c = col[r + kPad];
    // ring 0 (-3, 0) and 8 (+3, 0), ring 4 (0, +3) and 12 (0, -3): two
    // adjacent compass differences beyond t <=> one of each opposite pair,
    // and max(fl(n - c), fl(s - c)) = fl(max(n, s) - c)
    const float n = col[r], s = col[r + 2 * kPad];
    const float e = tile[ly0 + r + kPad][lx + 2 * kPad], w = tile[ly0 + r + kPad][lx];
    const bool inside = gx < W && y0 + ly0 + r < H;
    const bool bright = inside && (fmaxf(n, s) - c > t) & (fmaxf(e, w) - c > t);
    const bool dark = inside && (fminf(n, s) - c < -t) & (fminf(e, w) - c < -t);
    bits |= ((unsigned)bright | ((unsigned)dark << 1)) << (2 * r);
    ballot_b[r] = __ballot_sync(0xffffffffu, bright);
    ballot_d[r] = __ballot_sync(0xffffffffu, dark);
    total_b += __popc(ballot_b[r]);
    total_d += __popc(ballot_d[r]);
  }

  // B. compact: bright candidates from the front of the list, dark ones
  // from the back, one slot range of each per warp
  int base_b = 0, base_d = 0;
  if (lane == 0) {
    if (total_b) base_b = atomicAdd(&count[0], total_b);
    if (total_d) base_d = atomicAdd(&count[1], total_d);
  }
  base_b = __shfl_sync(0xffffffffu, base_b, 0);
  base_d = __shfl_sync(0xffffffffu, base_d, 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const unsigned short off = (unsigned short)((ly0 + r) * kTW + lx);
    if ((bits >> (2 * r)) & 1u) list[base_b + __popc(ballot_b[r] & below)] = off;
    if ((bits >> (2 * r)) & 2u) list[kList - 1 - base_d - __popc(ballot_d[r] & below)] = off;
    base_b += __popc(ballot_b[r]);
    base_d += __popc(ballot_d[r]);
  }
  __syncthreads();

  // C. the arcs of each listed polarity: warps are bright or dark, apart
  // from the one that straddles the two ends.  By monotone rounding,
  // max_k min_arc fl(ring - c) = fl(max_k min_arc ring - c), and the dark
  // score max_k min_arc fl(c - ring) = fl(c - min_k max_arc ring).
  const int nb = count[0], n = nb + count[1];
  for (int j = tid; j < n; j += kThreads) {
    const bool dark = j >= nb;
    const int off = list[dark ? kList - 1 - (j - nb) : j];
    const float* C = &tile[off / kTW + kPad][off % kTW + kPad];
    float ring[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) ring[k] = C[kDy[k] * kInW + kDx[k]];
    if (dark) dark_score[off] = C[0] - best_arc<true>(ring);
    else bright_score[off] = best_arc<false>(ring) - C[0];
  }
  __syncthreads();

  // D. store the tile: the larger set polarity's score above the
  // threshold, zeros elsewhere
  float* o = out + (size_t)b * H * W;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gy = y0 + ly0 + r;
    const unsigned pol = (bits >> (2 * r)) & 3u;
    const int off = (ly0 + r) * kTW + lx;
    float score = 0.0f;
    if (pol) {
      float s = (pol & 1u) ? bright_score[off] : -INFINITY;
      if (pol & 2u) s = fmaxf(s, dark_score[off]);
      score = s > t ? s : 0.0f;
    }
    if (gx < W && gy < H) o[(size_t)gy * W + gx] = score;
  }
}

}  // namespace

extern "C" int fast_scores_launch(const float* img, float* out, int B, int H,
                                  int W, float threshold, cudaStream_t stream) {
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  fast_scores_kernel<<<grid, kThreads, 0, stream>>>(img, out, H, W, threshold);
  return (int)cudaGetLastError();
}

// Whole Gauss-Newton burst on the rectified-stereo factor in one CTA
// (kernel K2).
//
// Replaces srrg2_proslam_tpu/ops/gn_pallas.py::gn_burst_stereo.  Each of
// `iterations` steps: transform the active map points by the pose X,
// project to (uL, vL, uR), form the residual and the 3x6 Jacobian, weight
// by the saturated robust kernel at chi_threshold, and reduce the 21 upper
// H entries, the 6 b entries and (chi, inliers, terms) over the block.  The
// block then solves (H + damping I) dx = -b, zeroes a non-finite dx,
// composes X <- exp(dx) X with the f32-stable coefficients of ops/se3.py,
// and applies the stop rule of ops/gn.py::gn_iterate: a step applies only
// while the previous twist norm exceeds epsilon and at least min_inliers
// terms are active; the burst ends once a step's norm is not above epsilon
// (or a step is refused).
//
// The solve is an LDL^T factorisation in double precision of H + damping I
// divided by its largest diagonal entry.  The TPU kernel's f32 cofactor
// Schur solve overflows for large H and returns a finite but wrong dx; the
// prescaled factorisation keeps its pivots near 1.
//
// Bound on the card: latency.  The arithmetic is ~150 flops per active
// correspondence and iteration, so the cost is the chain of 5 dependent
// block reductions and solves.  The design shortens that chain:
//  * Load once.  The masked-in correspondences are compacted (a block scan
//    keeps their order) and each thread holds its share in registers for
//    the whole burst; masked-out rows never contribute, and on the KITTI
//    path only ~100-150 of the 1152 rows are matched.
//  * Transposed warp reduction.  The 30 sums, padded to 32, are reduced by
//    recursive halving: 31 shuffles leave sum k in lane k.  Lane k of every
//    warp then adds partial[w][k] over the warps, the 30 sums in parallel.
//  * One barrier per iteration.  Every warp sums the same partials in the
//    same order and runs the same solve, so every thread holds the same
//    pose and stop flag in registers and no thread has to publish them;
//    the partials are double-buffered, so a warp that runs ahead cannot
//    overwrite the buffer another warp is still reading.  Warps that hold
//    no rows leave after the load (on the KITTI path 3-5 of the 8 stay),
//    so the redundant solves and the barrier involve only the others.
//  * A short serial tail: one double reciprocal per pivot, one sincosf.
#include <cuda_runtime.h>
#include <math.h>

// Threads of the CTA; scripts/gn_threads_torch.py builds the library with
// -DGN_BURST_THREADS=512 to time the other candidate (PERF.md).
#ifndef GN_BURST_THREADS
#define GN_BURST_THREADS 256
#endif

namespace {

constexpr int kThreads = GN_BURST_THREADS;
constexpr int kWarps = kThreads / 32;
// correspondences held in registers per thread: the KITTI setting's 1152
// keypoints fit; rows beyond are re-read from global memory each iteration
constexpr int kPer = (1152 + kThreads - 1) / kThreads;
constexpr int kH = 21;            // upper triangle of the 6x6 H
constexpr int kB = kH;            // b at [21, 27)
constexpr int kChi = kB + 6;      // robust chi sum
constexpr int kInl = kChi + 1;    // inlier count
constexpr int kTerms = kInl + 1;  // active-term count
constexpr int kSums = kTerms + 1;
static_assert(kSums <= 32, "one sum per lane");
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float fx, fy, cx, cy, bpx, range_min, chi_threshold;
};

__device__ __forceinline__ int upper_index(int i, int j) {
  // row-major index of (i, j), i <= j, in the packed upper triangle of 6x6
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

// Adds one correspondence's H, b and stats terms to acc.
__device__ __forceinline__ void accumulate(const float* X, const float* q,
                                           const float* m, float w_in,
                                           const Params& p, float* acc) {
  const float px = X[0] * q[0] + X[1] * q[1] + X[2] * q[2] + X[3];
  const float py = X[4] * q[0] + X[5] * q[1] + X[6] * q[2] + X[7];
  const float pz = X[8] * q[0] + X[9] * q[1] + X[10] * q[2] + X[11];
  const float iz = 1.0f / fmaxf(pz, 1e-3f);
  const float iz2 = iz * iz;
  const float u_l = p.fx * px * iz + p.cx;
  const float v_l = p.fy * py * iz + p.cy;
  const float u_r = u_l - p.bpx * iz;
  const float r[3] = {u_l - m[0], v_l - m[1], u_r - m[2]};
  // projection Jacobian rows wrt the camera-frame point
  const float jp[3][3] = {{p.fx * iz, 0.0f, -p.fx * px * iz2},
                          {0.0f, p.fy * iz, -p.fy * py * iz2},
                          {p.fx * iz, 0.0f, (-p.fx * px + p.bpx) * iz2}};
  // J[d] = [Jp[d] | -(Jp[d] @ skew(p))]
  float J[3][6];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    J[d][0] = jp[d][0];
    J[d][1] = jp[d][1];
    J[d][2] = jp[d][2];
    J[d][3] = -(jp[d][1] * pz - jp[d][2] * py);
    J[d][4] = -(jp[d][2] * px - jp[d][0] * pz);
    J[d][5] = -(jp[d][0] * py - jp[d][1] * px);
  }
  const bool active = pz > p.range_min;
  const float chi = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * w_in;
  const float kw = fminf(1.0f, p.chi_threshold / fmaxf(chi, 1e-12f));
  const float wgt = active ? w_in * kw : 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      acc[upper_index(i, j)] +=
          (J[0][i] * J[0][j] + J[1][i] * J[1][j] + J[2][i] * J[2][j]) * wgt;
    }
    acc[kB + i] += (J[0][i] * r[0] + J[1][i] * r[1] + J[2][i] * r[2]) * wgt;
  }
  if (active) {
    acc[kChi] += fminf(chi, p.chi_threshold);
    acc[kInl] += chi <= p.chi_threshold ? 1.0f : 0.0f;
    acc[kTerms] += 1.0f;
  }
}

// One recursive-halving step of the transposed warp reduction: lanes with
// bit O set keep the upper O of their 2*O values and send the lower O to
// the partner lane ^ O, which keeps the lower.
template <int O>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// Sum of v[k] over the warp, for k = lane (31 shuffles).
__device__ __forceinline__ float warp_transpose_sum(float* v, int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// Solve (H + damping I) x = rhs for symmetric positive definite H; returns
// false when a pivot is not positive or a value is not finite.
__device__ __forceinline__ bool solve6_ldlt(const float* tot, float damping,
                                            float* x) {
  double A[6][6], r[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = A[j][i] = (double)tot[upper_index(i, j)];
    }
    A[i][i] += (double)damping;
    r[i] = (double)tot[kB + i];
  }
  double scale = 0.0;
#pragma unroll
  for (int i = 0; i < 6; ++i) scale = fmax(scale, fabs(A[i][i]));
  if (!(scale > 0.0) || !isfinite(scale)) return false;
  const double inv_scale = 1.0 / scale;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] *= inv_scale;
    r[i] *= inv_scale;
  }
  double L[6][6], D[6], inv_D[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    double d = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k] * D[k];
    if (!(d > 0.0)) return false;
    D[j] = d;
    inv_D[j] = 1.0 / d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      double s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k] * D[k];
      L[i][j] = s * inv_D[j];
    }
  }
  double z[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double s = r[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * z[k];
    z[i] = s;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) z[i] *= inv_D[i];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double s = z[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * z[k];
    z[i] = s;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = (float)z[i];
  return true;
}

// X <- exp(dx) X on the rows of [R | t] (12 floats, row-major 3x4).
__device__ __forceinline__ void exp_compose(const float* dx, float* X) {
  const float eps = 1e-8f;
  const float w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta2 + eps);
  float A, B, C;
  if (theta2 < 1e-2f) {
    A = 1.0f - theta2 / 6.0f + theta2 * theta2 / 120.0f;
    B = 0.5f - theta2 / 24.0f + theta2 * theta2 / 720.0f;
    C = 1.0f / 6.0f - theta2 / 120.0f + theta2 * theta2 / 5040.0f;
  } else {
    float half_sin, half_cos;
    sincosf(0.5f * theta, &half_sin, &half_cos);
    const float sin_theta = 2.0f * half_sin * half_cos;
    A = sin_theta / theta;
    B = 2.0f * half_sin * half_sin / (theta2 + eps);
    C = (theta - sin_theta) / (theta2 * theta + eps);
  }
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float Rd[3][3], Vm[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2ij = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      Rd[i][j] = eye + A * W[i][j] + B * w2ij;
      Vm[i][j] = eye + B * W[i][j] + C * w2ij;
    }
  }
  float out[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = Rd[i][0] * X[j] + Rd[i][1] * X[4 + j] + Rd[i][2] * X[8 + j];
    }
    out[4 * i + 3] += Vm[i][0] * dx[0] + Vm[i][1] * dx[1] + Vm[i][2] * dx[2];
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) X[k] = out[k];
}

__global__ void __launch_bounds__(kThreads)
gn_burst_stereo_kernel(const float* __restrict__ X0,
                       const float* __restrict__ pts,      // [C, 3]
                       const float* __restrict__ meas,     // [C, 3] (uL, vL, uR)
                       const float* __restrict__ weights,  // [C]
                       const unsigned char* __restrict__ mask,  // [C]
                       float* __restrict__ out,  // X [16], chi, then int32 inliers, terms
                       int C, int iterations, Params prm, float damping,
                       float epsilon, int min_inliers) {
  extern __shared__ int s_idx[];  // [C]: masked-in rows in order, then unused
  __shared__ int s_warp_count[kWarps];
  __shared__ float partial[2][kWarps * 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // ---- compact the masked-in rows: thread t scans rows [c0, c1) -------------
  const int span = (C + kThreads - 1) / kThreads;
  const int c0 = min(tid * span, C), c1 = min(c0 + span, C);
  int count = 0;
  for (int c = c0; c < c1; ++c) count += mask[c] != 0;
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp_count[warp] = incl;
  __syncthreads();
  int slot = incl - count, active_rows = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_warp_count[w];
    slot += w < warp ? v : 0;
    active_rows += v;
  }
  for (int c = c0; c < c1; ++c) {
    if (mask[c] != 0) s_idx[slot++] = c;
  }
  __syncthreads();

  // ---- load once: compacted row tid + j * kThreads into registers -----------
  float q[kPer][3], m[kPer][3], w_in[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = tid + j * kThreads;
    const int c = k < active_rows ? s_idx[k] : 0;
    const bool have = k < active_rows;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      q[j][d] = have ? __ldg(pts + 3 * c + d) : 0.0f;
      m[j][d] = have ? __ldg(meas + 3 * c + d) : 0.0f;
    }
    w_in[j] = have ? __ldg(weights + c) : 0.0f;
  }
  float X[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) X[k] = __ldg(X0 + k);
  // the rows sit in the lowest threads: a warp without rows adds nothing
  // and leaves; the others (warp 0 at least, which writes the output) meet
  // at a barrier sized to them
  const int live_warps = max(1, (min(active_rows, kThreads) + 31) / 32);
  if (warp >= live_warps) return;

  float dx_norm = INFINITY, chi_total = 0.0f, inliers = 0.0f, terms = 0.0f;
  for (int it = 0; it < iterations; ++it) {
    if (!(dx_norm > epsilon)) break;  // uniform: every thread holds the same value
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (tid + j * kThreads < active_rows) accumulate(X, q[j], m[j], w_in[j], prm, acc);
    }
    for (int k = tid + kPer * kThreads; k < active_rows; k += kThreads) {
      const int c = s_idx[k];
      const float qc[3] = {pts[3 * c], pts[3 * c + 1], pts[3 * c + 2]};
      const float mc[3] = {meas[3 * c], meas[3 * c + 1], meas[3 * c + 2]};
      accumulate(X, qc, mc, weights[c], prm, acc);
    }

    float* part = partial[it & 1];
    part[warp * 32 + lane] = warp_transpose_sum(acc, lane);
    asm volatile("bar.sync 1, %0;" ::"r"(live_warps * 32) : "memory");
    float mine = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < live_warps) mine += part[w * 32 + lane];
    }
    float tot[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) tot[k] = __shfl_sync(kFull, mine, k);

    float dx[6];
    bool finite = solve6_ldlt(tot, damping, dx);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      dx[k] = -dx[k];
      finite = finite && isfinite(dx[k]);
    }
    if (!finite) {
#pragma unroll
      for (int k = 0; k < 6; ++k) dx[k] = 0.0f;
    }
    const bool ok = tot[kTerms] >= (float)min_inliers;
    if (ok) exp_compose(dx, X);
    float step2 = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) step2 += dx[k] * dx[k];
    dx_norm = ok ? sqrtf(step2) : 0.0f;
    chi_total = tot[kChi];
    inliers = tot[kInl];
    terms = tot[kTerms];
  }

  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) out[k] = X[k];
#pragma unroll
    for (int k = 12; k < 16; ++k) out[k] = X0[k];
    out[16] = chi_total;
    int* counts = reinterpret_cast<int*>(out + 17);
    counts[0] = (int)inliers;
    counts[1] = (int)terms;
  }
}

}  // namespace

extern "C" int gn_burst_stereo_launch(
    const float* X0, const float* pts, const float* meas, const float* weights,
    const unsigned char* mask, float* out, int C, int iterations, float fx,
    float fy, float cx, float cy, float bpx, float range_min,
    float chi_threshold, float damping, float epsilon, int min_inliers,
    cudaStream_t stream) {
  const size_t smem = (size_t)C * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_burst_stereo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Params prm{fx, fy, cx, cy, bpx, range_min, chi_threshold};
  gn_burst_stereo_kernel<<<1, kThreads, smem, stream>>>(
      X0, pts, meas, weights, mask, out, C, iterations, prm, damping, epsilon,
      min_inliers);
  return (int)cudaGetLastError();
}

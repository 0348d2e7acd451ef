// Whole Gauss-Newton burst on the rectified-stereo factor in one CTA
// (kernel K2).
//
// Replaces srrg2_proslam_tpu/ops/gn_pallas.py::gn_burst_stereo.  Each of
// `iterations` steps: transform the C map points by the pose X (held in
// shared memory), project to (uL, vL, uR), form the residual and the 3x6
// Jacobian, weight by the saturated robust kernel at chi_threshold, and
// reduce the 21 upper H entries, the 6 b entries and (chi, inliers, terms)
// over the block.  Thread 0 then solves (H + damping I) dx = -b, zeroes a
// non-finite dx, composes X <- exp(dx) X with the f32-stable coefficients
// of ops/se3.py, and applies the stop rule of ops/gn.py::gn_iterate: a step
// applies only while the previous twist norm exceeds epsilon and at least
// min_inliers terms are active; the burst ends once a step's norm is not
// above epsilon (or a step is refused).
//
// The solve is an LDL^T factorisation in double precision of H + damping I
// divided by its largest diagonal entry.  The TPU kernel's f32 cofactor
// Schur solve overflows for large H and returns a finite but wrong dx; the
// prescaled factorisation keeps its pivots near 1.
//
// Bound on the card: latency.  The arithmetic is ~150 flops per point and
// iteration (C ~ 1152), so one CTA of 256 threads does the whole burst and
// the cost is the chain of 5 dependent block reductions and single-thread
// solves, not bandwidth; keeping the pose in shared memory removes the
// host round trip and the ~10 launches per iteration of the plain version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kH = 21;            // upper triangle of the 6x6 H
constexpr int kB = kH;            // b at [21, 27)
constexpr int kChi = kB + 6;      // robust chi sum
constexpr int kInl = kChi + 1;    // inlier count
constexpr int kTerms = kInl + 1;  // active-term count
constexpr int kSums = kTerms + 1;

__device__ __forceinline__ int upper_index(int i, int j) {
  // row-major index of (i, j), i <= j, in the packed upper triangle of 6x6
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

// Solve (H + damping I) x = rhs for symmetric positive definite H; returns
// false when a pivot is not positive or a value is not finite.
__device__ bool solve6_ldlt(const float* tot, float damping, float* x) {
  double A[6][6], r[6];
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      A[i][j] = A[j][i] = (double)tot[upper_index(i, j)];
    }
    A[i][i] += (double)damping;
    r[i] = (double)tot[kB + i];
  }
  double scale = 0.0;
  for (int i = 0; i < 6; ++i) scale = fmax(scale, fabs(A[i][i]));
  if (!(scale > 0.0) || !isfinite(scale)) return false;
  const double inv_scale = 1.0 / scale;
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) A[i][j] *= inv_scale;
    r[i] *= inv_scale;
  }
  double L[6][6] = {}, D[6];
  for (int j = 0; j < 6; ++j) {
    double d = A[j][j];
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k] * D[k];
    if (!(d > 0.0)) return false;
    D[j] = d;
    L[j][j] = 1.0;
    for (int i = j + 1; i < 6; ++i) {
      double s = A[i][j];
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k] * D[k];
      L[i][j] = s / d;
    }
  }
  double z[6];
  for (int i = 0; i < 6; ++i) {
    double s = r[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * z[k];
    z[i] = s;
  }
  for (int i = 0; i < 6; ++i) z[i] /= D[i];
  for (int i = 5; i >= 0; --i) {
    double s = z[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * z[k];
    z[i] = s;
  }
  for (int i = 0; i < 6; ++i) x[i] = (float)z[i];
  return true;
}

// X <- exp(dx) X on the rows of [R | t] (12 floats, row-major 3x4).
__device__ void exp_compose(const float* dx, float* X) {
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
    const float half_sin = sinf(0.5f * theta);
    A = sinf(theta) / theta;
    B = 2.0f * half_sin * half_sin / (theta2 + eps);
    C = (theta - sinf(theta)) / (theta2 * theta + eps);
  }
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float Rd[3][3], Vm[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float w2ij = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      Rd[i][j] = eye + A * W[i][j] + B * w2ij;
      Vm[i][j] = eye + B * W[i][j] + C * w2ij;
    }
  }
  float out[12];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = Rd[i][0] * X[j] + Rd[i][1] * X[4 + j] + Rd[i][2] * X[8 + j];
    }
    out[4 * i + 3] += Vm[i][0] * dx[0] + Vm[i][1] * dx[1] + Vm[i][2] * dx[2];
  }
  for (int k = 0; k < 12; ++k) X[k] = out[k];
}

__global__ void __launch_bounds__(kThreads)
gn_burst_stereo_kernel(const float* __restrict__ X0,
                       const float* __restrict__ pts,      // [C, 3]
                       const float* __restrict__ meas,     // [C, 3] (uL, vL, uR)
                       const float* __restrict__ weights,  // [C]
                       const unsigned char* __restrict__ mask,  // [C]
                       float* __restrict__ out,  // X [16], chi, inliers, terms
                       int C, int iterations, float fx, float fy, float cx,
                       float cy, float bpx, float range_min,
                       float chi_threshold, float damping, float epsilon,
                       int min_inliers) {
  __shared__ float sX[12];
  __shared__ float partial[kWarps][kSums];
  __shared__ float s_dx_norm;
  __shared__ float s_stats[3];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid < 12) sX[tid] = X0[tid];
  if (tid == 0) {
    s_dx_norm = INFINITY;
    s_stats[0] = s_stats[1] = s_stats[2] = 0.0f;
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    if (!(s_dx_norm > epsilon)) break;  // uniform: read after a barrier
    float X[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) X[k] = sX[k];
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

    for (int c = tid; c < C; c += kThreads) {
      const float qx = pts[3 * c], qy = pts[3 * c + 1], qz = pts[3 * c + 2];
      const float px = X[0] * qx + X[1] * qy + X[2] * qz + X[3];
      const float py = X[4] * qx + X[5] * qy + X[6] * qz + X[7];
      const float pz = X[8] * qx + X[9] * qy + X[10] * qz + X[11];
      const float iz = 1.0f / fmaxf(pz, 1e-3f);
      const float iz2 = iz * iz;
      const float u_l = fx * px * iz + cx;
      const float v_l = fy * py * iz + cy;
      const float u_r = u_l - bpx * iz;
      const float r[3] = {u_l - meas[3 * c], v_l - meas[3 * c + 1],
                          u_r - meas[3 * c + 2]};
      // projection Jacobian rows wrt the camera-frame point
      const float jp[3][3] = {{fx * iz, 0.0f, -fx * px * iz2},
                              {0.0f, fy * iz, -fy * py * iz2},
                              {fx * iz, 0.0f, (-fx * px + bpx) * iz2}};
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
      const float w_in = weights[c];
      const bool active = mask[c] != 0 && pz > range_min;
      const float chi = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * w_in;
      const float kw = fminf(1.0f, chi_threshold / fmaxf(chi, 1e-12f));
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
        acc[kChi] += fminf(chi, chi_threshold);
        acc[kInl] += chi <= chi_threshold ? 1.0f : 0.0f;
        acc[kTerms] += 1.0f;
      }
    }

#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float v = acc[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) partial[warp][k] = v;
    }
    __syncthreads();

    if (tid == 0) {
      float tot[kSums];
      for (int k = 0; k < kSums; ++k) {
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s += partial[w][k];
        tot[k] = s;
      }
      float dx[6];
      bool finite = solve6_ldlt(tot, damping, dx);
      for (int k = 0; k < 6; ++k) {
        dx[k] = -dx[k];
        finite = finite && isfinite(dx[k]);
      }
      if (!finite) {
        for (int k = 0; k < 6; ++k) dx[k] = 0.0f;
      }
      const bool ok = tot[kTerms] >= (float)min_inliers;
      if (ok) exp_compose(dx, sX);
      float step2 = 0.0f;
      for (int k = 0; k < 6; ++k) step2 += dx[k] * dx[k];
      s_dx_norm = ok ? sqrtf(step2) : 0.0f;
      s_stats[0] = tot[kChi];
      s_stats[1] = tot[kInl];
      s_stats[2] = tot[kTerms];
    }
    __syncthreads();
  }

  if (tid < 16) out[tid] = tid < 12 ? sX[tid] : X0[tid];
  if (tid < 3) out[16 + tid] = s_stats[tid];
}

}  // namespace

extern "C" int gn_burst_stereo_launch(
    const float* X0, const float* pts, const float* meas, const float* weights,
    const unsigned char* mask, float* out, int C, int iterations, float fx,
    float fy, float cx, float cy, float bpx, float range_min,
    float chi_threshold, float damping, float epsilon, int min_inliers,
    cudaStream_t stream) {
  gn_burst_stereo_kernel<<<1, kThreads, 0, stream>>>(
      X0, pts, meas, weights, mask, out, C, iterations, fx, fy, cx, cy, bpx,
      range_min, chi_threshold, damping, epsilon, min_inliers);
  return (int)cudaGetLastError();
}

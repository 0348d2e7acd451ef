"""SE(3) operations on 4x4 float32 matrices (batched over leading dims).

Port of srrg2_proslam_tpu/ops/se3.py.  Conventions: ``p_dest = T @ [p_src, 1]``
and ``exp`` takes the left-multiplied twist ``[v, w]`` (translation first),
matching the Gauss-Newton update ``T <- exp(dx) @ T``.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 transform from a 3x3 rotation and a 3-translation."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)     # a fill: assigning a Python scalar syncs on the card
    return T


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return from_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply ``T`` to points of shape [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices of [..., 3] vectors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _exp_coefficients(theta2: torch.Tensor):
    """f32-stable A = sin(t)/t, B = (1-cos t)/t^2, C = (t-sin t)/t^3.

    B uses the half-angle form 1-cos t = 2 sin^2(t/2); A, B and C switch to
    their Taylor series below t < 0.1, where the closed forms cancel in
    float32.  Inter-frame VO rotations live in that regime: the pose
    explodes when these forms regress.
    """
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-2
    A = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                    torch.sin(theta) / theta)
    half_sin = torch.sin(0.5 * theta)
    B = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    2.0 * half_sin * half_sin / (theta2 + _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    return A, B, C


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with the f32-safe coefficients."""
    theta2 = torch.sum(w * w, dim=-1)
    W = skew(w)
    A, B, _ = _exp_coefficients(theta2)
    return _eye3_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of R, with theta = atan2(|antisym|/2, (trace-1)/2)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = 0.5 * torch.sqrt(torch.sum(v * v, dim=-1) + _EPS)
    cos_t = (trace - 1.0) * 0.5
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_t + _EPS))
    return scale[..., None] * v


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 exp of twists [..., 6] = [v, w] -> 4x4 transforms."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    W = skew(w)
    _, B, C = _exp_coefficients(theta2)
    R = exp_so3(w)
    V = _eye3_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)
    t = torch.einsum("...ij,...j->...i", V, v)
    return from_rt(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """se3 log -> twists [..., 6] = [v, w]."""
    w = log_so3(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = skew(w)
    small = theta2 < 1e-2
    half = 0.5 * theta
    cot_half = torch.cos(half) / (torch.sin(half) + _EPS)
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - half * cot_half) / (theta2 + _EPS),
    )
    Vinv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return torch.cat([v, w], dim=-1)


def error_t_and_angle(A: torch.Tensor, B: torch.Tensor):
    """(|t| per axis, rotation angle) of the error transform A^-1 B."""
    E = inverse(A) @ B
    t_err = E[..., :3, 3].abs()
    w = log_so3(E[..., :3, :3])
    return t_err, torch.sqrt(torch.sum(w * w, dim=-1))


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block (SVD projection onto SO(3))."""
    u, _, vt = torch.linalg.svd(T[..., :3, :3])
    d = torch.ones(T.shape[:-2] + (3,), dtype=T.dtype, device=T.device)
    d[..., 2] = torch.linalg.det(u @ vt)
    return from_rt((u * d[..., None, :]) @ vt, T[..., :3, 3])

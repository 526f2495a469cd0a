"""SE(2)/SO(3)/SE(3) Lie-group math in PyTorch, plus float64 numpy host
helpers.

The counterpart of ``navtech_radar_slam_tpu.utils.geometry`` (that module
imports jax at its top, so the port cannot borrow it).  Layouts are the JAX
module's:

  * SE(2) pose   : (..., 3)    = [x, y, theta]
  * SE(3) pose   : (..., 4, 4) homogeneous matrix
  * SE(3) tangent: (..., 6)    = [rho(3), phi(3)]

Every torch function broadcasts over leading dims and is safe under
``torch.func`` transforms: the pose graph takes ``jvp`` and ``vjp`` through
``se3_exp``, ``se3_log`` and ``se3_between``.  The guard formulas (the
``_EPS`` sqrt guards, the ``atan2`` angle, the near-pi branch with its 1e-10
floor) are JAX's, term for term: an "equivalent" formula is where NaN
gradients come from.  Matrices are built with ``stack``/``cat``, never by
writing into a ``zeros`` tensor.  Matmuls are true float32 (the package
turns TF32 off).

The per-scan pose bookkeeping runs on the host in f64 numpy, as in the JAX
package (``*_np``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-8


# ---------------------------------------------------------------------------
# SE(2)
# ---------------------------------------------------------------------------

def se2_identity(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(3, dtype=dtype, device=device)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def se2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose SE(2) poses: a ∘ b (apply b in a's frame)."""
    xa, ya, ta = a[..., 0], a[..., 1], a[..., 2]
    xb, yb, tb = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(ta), torch.sin(ta)
    x = xa + c * xb - s * yb
    y = ya + s * xb + c * yb
    return torch.stack([x, y, wrap_angle(ta + tb)], dim=-1)


def se2_inv(a: torch.Tensor) -> torch.Tensor:
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    return torch.stack([-(c * x + s * y), -(-s * x + c * y), -t], dim=-1)


def se2_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative pose a^{-1} ∘ b (gtsam ``between``)."""
    return se2_mul(se2_inv(a), b)


def se2_apply(a: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform points (..., N, 2) by pose(s) (..., 3)."""
    c, s = torch.cos(a[..., 2:3]), torch.sin(a[..., 2:3])
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([c * x - s * y + a[..., 0:1],
                        s * x + c * y + a[..., 1:2]], dim=-1)


def se2_to_se3(p: torch.Tensor) -> torch.Tensor:
    """Lift [x, y, theta] to a 4x4 SE(3) matrix (z = 0, roll = pitch = 0)."""
    x, y, t = p[..., 0], p[..., 1], p[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([
        torch.stack([c, -s, zero, x], dim=-1),
        torch.stack([s, c, zero, y], dim=-1),
        torch.stack([zero, zero, one, zero], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ], dim=-2)


def se3_to_se2(T: torch.Tensor) -> torch.Tensor:
    """Project an SE(3) matrix to [x, y, yaw]."""
    return torch.stack([T[..., 0, 3], T[..., 1, 3],
                        torch.atan2(T[..., 1, 0], T[..., 0, 0])], dim=-1)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with a Taylor guard near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16))
    W = so3_hat(w)
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _vee_asym(R: torch.Tensor) -> torch.Tensor:
    return torch.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> R^3, robust near 0 and pi (JAX's formulas: theta from
    atan2(|vee(R - R^T)|/2, (trace - 1)/2); near pi the axis from the
    diagonal of (R + I)/2, floored at 1e-10 so the backward pass stays
    finite at exactly pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = (trace - 1.0) * 0.5
    v = _vee_asym(R) * 0.5
    sin2 = torch.sum(v * v, dim=-1)
    sin_t = torch.sqrt(sin2 + _EPS * _EPS)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(small, 1.0 + theta * theta / 6.0, theta / sin_t)
    w_generic = v * scale[..., None]
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp(diag, min=1e-10))
    axis = axis * torch.sign(_vee_asym(R) + 1e-20)
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True).clamp(min=1e-12)
    w_pi = axis / norm * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta).clamp(min=1e-16))
    return _eye3_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    half_theta = theta * 0.5
    sin_h = torch.sin(half_theta)
    cot = torch.cos(half_theta) / torch.where(sin_h == 0, torch.ones_like(sin_h), sin_h)
    k = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half_theta * cot) / theta2.clamp(min=1e-16))
    return _eye3_like(W) - 0.5 * W + k[..., None, None] * (W @ W)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_identity(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def se3_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R t; 0 1] built with cat/stack (no in-place writes)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)                   # (..., 3, 4)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom = bottom + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                                   device=R.device)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exp map R^6 -> SE(3); xi = [rho, phi]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = (_so3_left_jacobian(phi) @ rho[..., :, None])[..., 0]
    return se3_from_rt(so3_exp(phi), t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(T[..., :3, :3])
    rho = (_so3_left_jacobian_inv(phi) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_from_rt(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_between(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """gtsam Pose3::between — A^{-1} B."""
    return se3_inv(A) @ B


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform points (..., N, 3) by SE(3) (..., 4, 4)."""
    return (torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts)
            + T[..., None, :3, 3])


# ---------------------------------------------------------------------------
# Euler RPY (gtsam convention: R = Rz(yaw) Ry(pitch) Rx(roll))
# ---------------------------------------------------------------------------

def rpy_to_rotmat(roll: torch.Tensor, pitch: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def pose6d_to_se3(p: torch.Tensor) -> torch.Tensor:
    """[x, y, z, roll, pitch, yaw] -> 4x4, the reference's Pose6D."""
    return se3_from_rt(rpy_to_rotmat(p[..., 3], p[..., 4], p[..., 5]), p[..., :3])


def se3_to_pose6d(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    pitch = -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.cat([T[..., :3, 3], torch.stack([roll, pitch, yaw], dim=-1)], dim=-1)


# ---------------------------------------------------------------------------
# SE(2), host-side float64 numpy
# ---------------------------------------------------------------------------

def se2_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose two [x, y, theta] poses: a ∘ b, heading wrapped to (-pi, pi]."""
    c, s = np.cos(a[2]), np.sin(a[2])
    t = a[2] + b[2]
    return np.asarray(
        [a[0] + c * b[0] - s * b[1],
         a[1] + s * b[0] + c * b[1],
         np.arctan2(np.sin(t), np.cos(t))], np.float64
    )


def se2_between_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Relative pose a⁻¹ ∘ b."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    t = b[2] - a[2]
    return np.asarray(
        [c * dx + s * dy, -s * dx + c * dy,
         np.arctan2(np.sin(t), np.cos(t))], np.float64
    )


def se2_to_se3_np(p: np.ndarray) -> np.ndarray:
    """[x, y, theta] -> 4x4 homogeneous transform."""
    c, s = np.cos(p[2]), np.sin(p[2])
    T = np.eye(4, dtype=np.float64)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = p[0], p[1]
    return T

"""3D rotation conversions in torch (quaternion / matrix / euler /
axis-angle / rot6d).

Port of ``livelyspeaker_tpu/ops/rotation.py``, the PyTorch3D-lineage
helpers: the BEAT records store motion as rot6d and export euler angles for
BVH and the metrics. Every function broadcasts over leading axes and is
differentiable.
"""

from __future__ import annotations

import torch

__all__ = [
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "axis_angle_to_quaternion",
    "quaternion_to_axis_angle",
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "rotation_6d_to_matrix",
    "matrix_to_rotation_6d",
]


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) real-first quaternions -> [..., 3, 3]."""
    r, i, j, k = torch.unbind(quaternions, -1)
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    m = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return m.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] real-first unit quaternions (stable
    branch-select form), with a non-negative real part."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    flr = torch.tensor(0.1, dtype=matrix.dtype, device=matrix.device)
    quat_candidates = quat_by_rijk / (2.0 * torch.maximum(q_abs[..., None], flr))
    best = torch.argmax(q_abs, dim=-1)
    index = best[..., None, None].expand(best.shape + (1, 4))
    out = torch.gather(quat_candidates, -2, index)[..., 0, :]
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    # canonical sign: non-negative real part (q and -q are the same rotation)
    return out * torch.where(out[..., :1] < 0, -1.0, 1.0)


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """[..., 3] intrinsic euler angles -> [..., 3, 3]
    (R = R1(c1) @ R2(c2) @ R3(c3))."""
    if len(convention) != 3:
        raise ValueError(f"convention {convention!r} is not three axes")
    matrices = [_axis_angle_rotation(c, euler_angles[..., i])
                for i, c in enumerate(convention)]
    return matrices[0] @ matrices[1] @ matrices[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] intrinsic euler angles."""
    if len(convention) != 3:
        raise ValueError(f"convention {convention!r} is not three axes")
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in (-1, 2) else 1.0
        central = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    eps = 1e-6
    small = torch.abs(angles) < eps
    sin_half_over = torch.where(
        small, 0.5 - (angles * angles) / 48, torch.sin(half) / torch.clamp(angles, min=eps))
    return torch.cat([torch.cos(half), axis_angle * sin_half_over], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2 * half_angles
    eps = 1e-6
    small = torch.abs(angles) < eps
    sin_half_over = torch.where(
        small,
        0.5 - (angles * angles) / 48,
        torch.sin(half_angles) / torch.where(small, torch.ones_like(angles), angles),
    )
    return quaternions[..., 1:] / sin_half_over


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """[..., 6] (first two matrix rows) -> [..., 3, 3] by Gram-Schmidt
    (Zhou et al., CVPR 2019)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: the first two rows flattened."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))

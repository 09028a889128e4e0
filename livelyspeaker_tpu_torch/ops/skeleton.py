"""TED skeleton math: direction-vector <-> joint-position conversions.

Port of ``livelyspeaker_tpu/ops/skeleton.py``. The TED representation is 9
unit direction vectors (bone directions) for a 10-joint upper body; poses
are recovered by cumulative forward kinematics along the static adjacency
with fixed bone lengths, written as one product with the [10, 9]
accumulation matrix. The constants are numpy (the record-building code needs them
without torch tensors); the conversions take and return torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DIR_VEC_PAIRS",
    "MEAN_DIR_VEC",
    "MEAN_POSE",
    "convert_dir_vec_to_pose",
    "convert_pose_seq_to_dir_vec",
    "normalize_dir_vec",
]

# (parent, child, bone_length)
DIR_VEC_PAIRS = (
    (0, 1, 0.26),
    (1, 2, 0.18),
    (2, 3, 0.14),
    (1, 4, 0.22),
    (4, 5, 0.36),
    (5, 6, 0.33),
    (1, 7, 0.22),
    (7, 8, 0.36),
    (8, 9, 0.33),
)

# Dataset normalisation constants of the TED records.
MEAN_DIR_VEC = np.array([
    0.0154009, -0.9690125, -0.0884354, -0.0022264, -0.8655276, 0.4342174,
    -0.0035145, -0.8755367, -0.4121039, -0.9236511, 0.3061306, -0.0012415,
    -0.5155854, 0.8129665, 0.0871897, 0.2348464, 0.1846561, 0.8091402,
    0.9271948, 0.2960011, -0.013189, 0.5233978, 0.8092403, 0.0725451,
    -0.2037076, 0.1924306, 0.8196916,
], dtype=np.float32)

MEAN_POSE = np.array([
    0.0000306, 0.0004946, 0.0008437, 0.0033759, -0.2051629, -0.0143453,
    0.0031566, -0.3054764, 0.0411491, 0.0029072, -0.4254303, -0.001311,
    -0.1458413, -0.1505532, -0.0138192, -0.2835603, 0.0670333, 0.0107002,
    -0.2280813, 0.112117, 0.2087789, 0.1523502, -0.1521499, -0.0161503,
    0.291909, 0.0644232, 0.0040145, 0.2452035, 0.1115339, 0.2051307,
], dtype=np.float32)


def _fk_matrix() -> np.ndarray:
    """[10, 9] accumulation matrix A with joint_pos = A @ (len * dir_vec):
    row j holds 1 for every bone on the path root -> joint j."""
    a = np.zeros((10, len(DIR_VEC_PAIRS)), dtype=np.float32)
    for b, (parent, child, _) in enumerate(DIR_VEC_PAIRS):
        a[child] = a[parent]
        a[child, b] = 1.0
    return a


_FK_A = _fk_matrix()
_BONE_LEN = np.array([p[2] for p in DIR_VEC_PAIRS], dtype=np.float32)
_PARENTS = [p[0] for p in DIR_VEC_PAIRS]
_CHILDREN = [p[1] for p in DIR_VEC_PAIRS]


def _as_xyz(t) -> torch.Tensor:
    t = torch.as_tensor(t)
    if t.shape[-1] != 3:
        t = t.reshape(t.shape[:-1] + (-1, 3))
    return t


def convert_dir_vec_to_pose(vec) -> torch.Tensor:
    """[..., 9, 3] (or [..., 27]) unit direction vectors -> [..., 10, 3]
    joint positions."""
    vec = _as_xyz(vec)
    scaled = vec * torch.as_tensor(_BONE_LEN, device=vec.device, dtype=vec.dtype)[:, None]
    a = torch.as_tensor(_FK_A, device=vec.device, dtype=vec.dtype)
    return torch.einsum("jb,...bc->...jc", a, scaled)


def normalize_dir_vec(vec: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalise along the last axis (zero vectors stay zero)."""
    norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    return vec / torch.clamp(norm, min=eps)


def convert_pose_seq_to_dir_vec(pose) -> torch.Tensor:
    """[..., 10, 3] (or [..., 30]) joint positions -> [..., 9, 3] unit
    direction vectors."""
    pose = _as_xyz(pose)
    vec = pose[..., _CHILDREN, :] - pose[..., _PARENTS, :]
    return normalize_dir_vec(vec)

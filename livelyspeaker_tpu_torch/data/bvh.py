"""BVH mocap file parser and writer.

Port of ``livelyspeaker_tpu/data/bvh.py`` (numpy, unchanged): the BEAT
offline pipeline reads 120 fps BVH through it, selects the body and finger
joints, and writes generated motion back into a BVH template.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["BvhJoint", "BvhData", "parse_bvh", "write_bvh",
           "bvh_world_positions"]


@dataclass
class BvhJoint:
    name: str
    parent: Optional[str]
    offset: Tuple[float, float, float]
    channels: List[str] = field(default_factory=list)
    children: List[str] = field(default_factory=list)
    is_end_site: bool = False


@dataclass
class BvhData:
    joints: Dict[str, BvhJoint]
    root: str
    frame_time: float
    frames: np.ndarray  # [T, total_channels]
    channel_order: List[Tuple[str, str]]  # (joint, channel) per column

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time

    def joint_channels(self, joint: str) -> np.ndarray:
        """[T, n_channels(joint)] view of the motion for one joint."""
        cols = [i for i, (j, _) in enumerate(self.channel_order) if j == joint]
        return self.frames[:, cols]

    def rotation_order(self, joint: str) -> str:
        """e.g. 'ZXY' from the channel declaration order."""
        return "".join(
            c[0] for c in self.joints[joint].channels if c.endswith("rotation")
        )

    def select_joints(self, names: List[str]) -> "BvhData":
        """Restrict the motion columns to the given joints (pymo
        JointSelector equivalent)."""
        cols = [
            i
            for i, (j, _) in enumerate(self.channel_order)
            if j in names
        ]
        order = [self.channel_order[i] for i in cols]
        return BvhData(
            joints=self.joints,
            root=self.root,
            frame_time=self.frame_time,
            frames=self.frames[:, cols],
            channel_order=order,
        )


def bvh_world_positions(data: BvhData) -> np.ndarray:
    """Forward kinematics: world joint positions [T, n_joints, 3] from the
    euler frames (pymo MocapParameterizer 'position' equivalent,
    preprocessing.py:14-225).  Joint order = hierarchy declaration order."""

    def euler_matrix(order: str, deg: np.ndarray) -> np.ndarray:
        """Intrinsic rotation in the declared channel order. deg [T, len]."""
        t = deg.shape[0]
        m = np.broadcast_to(np.eye(3), (t, 3, 3)).copy()
        for k, axis in enumerate(order):
            a = np.deg2rad(deg[:, k])
            c, s = np.cos(a), np.sin(a)
            r = np.zeros((t, 3, 3))
            if axis == "X":
                r[:, 0, 0] = 1
                r[:, 1, 1], r[:, 1, 2] = c, -s
                r[:, 2, 1], r[:, 2, 2] = s, c
            elif axis == "Y":
                r[:, 0, 0], r[:, 0, 2] = c, s
                r[:, 1, 1] = 1
                r[:, 2, 0], r[:, 2, 2] = -s, c
            else:
                r[:, 0, 0], r[:, 0, 1] = c, -s
                r[:, 1, 0], r[:, 1, 1] = s, c
                r[:, 2, 2] = 1
            m = m @ r
        return m

    t_total = len(data.frames)
    names = list(data.joints)
    world_rot: dict = {}
    world_pos: dict = {}
    col_of = {}
    for i, (j, c) in enumerate(data.channel_order):
        col_of.setdefault(j, {})[c] = i

    for name in names:
        j = data.joints[name]
        offset = np.asarray(j.offset)
        chans = col_of.get(name, {})
        rot_chans = [c for c in j.channels if c.endswith("rotation")]
        if rot_chans:
            order = "".join(c[0] for c in rot_chans)
            deg = np.stack(
                [data.frames[:, chans[c]] for c in rot_chans], axis=1
            )
            local_rot = euler_matrix(order, deg)
        else:
            local_rot = np.broadcast_to(np.eye(3), (t_total, 3, 3))
        pos_chans = [c for c in j.channels if c.endswith("position")]
        local_pos = np.broadcast_to(offset, (t_total, 3)).copy()
        if pos_chans:
            for c in pos_chans:
                axis = "XYZ".index(c[0])
                local_pos[:, axis] += data.frames[:, chans[c]]
        if j.parent is None:
            world_rot[name] = local_rot
            world_pos[name] = local_pos
        else:
            pr, pp = world_rot[j.parent], world_pos[j.parent]
            world_rot[name] = pr @ local_rot
            world_pos[name] = pp + np.einsum("tij,tj->ti", pr, local_pos)

    return np.stack([world_pos[n] for n in names], axis=1)


_TOKEN = re.compile(r"\S+")


def parse_bvh(path_or_text: str) -> BvhData:
    if "\n" not in path_or_text:
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text

    hier, _, motion = text.partition("MOTION")
    tokens = _TOKEN.findall(hier)
    joints: Dict[str, BvhJoint] = {}
    channel_order: List[Tuple[str, str]] = []
    stack: List[str] = []
    root = None
    i = 0
    end_count = 0
    while i < len(tokens):
        tok = tokens[i]
        up = tok.upper()
        if up in ("HIERARCHY",):
            i += 1
        elif up in ("ROOT", "JOINT"):
            name = tokens[i + 1]
            parent = stack[-1] if stack else None
            joints[name] = BvhJoint(name, parent, (0, 0, 0))
            if parent:
                joints[parent].children.append(name)
            if up == "ROOT":
                root = name
            stack.append(name)
            i += 2
        elif up == "END":  # "End Site"
            name = f"{stack[-1]}_EndSite{end_count}"
            end_count += 1
            joints[name] = BvhJoint(
                name, stack[-1], (0, 0, 0), is_end_site=True
            )
            joints[stack[-1]].children.append(name)
            stack.append(name)
            i += 2
        elif up == "OFFSET":
            j = joints[stack[-1]]
            j.offset = (
                float(tokens[i + 1]),
                float(tokens[i + 2]),
                float(tokens[i + 3]),
            )
            i += 4
        elif up == "CHANNELS":
            n = int(tokens[i + 1])
            chans = tokens[i + 2 : i + 2 + n]
            j = joints[stack[-1]]
            j.channels = chans
            channel_order.extend((j.name, c) for c in chans)
            i += 2 + n
        elif tok == "{":
            i += 1
        elif tok == "}":
            stack.pop()
            i += 1
        else:
            i += 1

    mtok = _TOKEN.findall(motion)
    assert mtok[0].upper() == "FRAMES:" or mtok[0].upper() == "FRAMES"
    k = 1 if mtok[0].upper() == "FRAMES:" else 2
    n_frames = int(mtok[k])
    # Frame Time: x.yz
    ft_idx = k + 1
    while not _is_float(mtok[ft_idx]):
        ft_idx += 1
    frame_time = float(mtok[ft_idx])
    values = np.asarray(mtok[ft_idx + 1 :], dtype=np.float64)
    n_ch = len(channel_order)
    values = values[: n_frames * n_ch].reshape(n_frames, n_ch)
    return BvhData(joints, root, frame_time, values, channel_order)


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _write_joint(lines, joints, name, indent):
    j = joints[name]
    pad = "  " * indent
    if j.is_end_site:
        lines.append(f"{pad}End Site")
        lines.append(f"{pad}{{")
        lines.append(
            f"{pad}  OFFSET {j.offset[0]:.6f} {j.offset[1]:.6f} {j.offset[2]:.6f}"
        )
        lines.append(f"{pad}}}")
        return
    kw = "ROOT" if j.parent is None else "JOINT"
    lines.append(f"{pad}{kw} {name}")
    lines.append(f"{pad}{{")
    lines.append(
        f"{pad}  OFFSET {j.offset[0]:.6f} {j.offset[1]:.6f} {j.offset[2]:.6f}"
    )
    if j.channels:
        lines.append(
            f"{pad}  CHANNELS {len(j.channels)} " + " ".join(j.channels)
        )
    for c in j.children:
        _write_joint(lines, joints, c, indent + 1)
    lines.append(f"{pad}}}")


def write_bvh(data: BvhData, path: Optional[str] = None) -> str:
    lines = ["HIERARCHY"]
    _write_joint(lines, data.joints, data.root, 0)
    lines.append("MOTION")
    lines.append(f"Frames: {len(data.frames)}")
    lines.append(f"Frame Time: {data.frame_time:.8f}")
    for row in data.frames:
        lines.append(" ".join(f"{v:.6f}" for v in row))
    text = "\n".join(lines) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text

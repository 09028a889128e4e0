"""Visualization and export of generated motion.

Port of ``livelyspeaker_tpu/utils/visualize.py``, on the port's own
skeleton, BEAT and BVH modules. It covers the reference's output tooling:
- matplotlib 3D skeleton videos (scripts/utils/train_utils.py:57-143
  ``create_video_and_save``; mp4 when ffmpeg is available, per-frame PNGs or
  GIF otherwise — this environment has no ffmpeg binary),
- BVH export of BEAT motion into a skeleton template for Blender
  (scripts_beat/dataloaders/data_tools.py:372-408 ``result2target_vis``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.skeleton import DIR_VEC_PAIRS, MEAN_DIR_VEC

__all__ = ["render_ted_clip", "export_beat_bvh"]


def _pose_frames_from_dir_vec(motion: np.ndarray) -> np.ndarray:
    """[T, 27] mean-subtracted dir vecs -> [T, 10, 3] joint positions."""
    from ..ops.skeleton import convert_dir_vec_to_pose

    vec = motion + MEAN_DIR_VEC[None, :]
    return convert_dir_vec_to_pose(torch.from_numpy(vec.reshape(-1, 9, 3))).numpy()


def render_ted_clip(
    motion: np.ndarray,  # [T, 27] mean-subtracted dir vecs
    out_path: str,
    title: str = "",
    fps: int = 15,
    audio: Optional[np.ndarray] = None,
    sr: int = 16000,
) -> str:
    """Render a TED clip to mp4 (ffmpeg) or animated GIF (fallback).

    Returns the path written.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    poses = _pose_frames_from_dir_vec(np.asarray(motion))
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")

    def draw(t):
        ax.clear()
        p = poses[t]
        for a, b, _ in DIR_VEC_PAIRS:
            ax.plot(
                [p[a, 0], p[b, 0]],
                [p[a, 2], p[b, 2]],
                [p[a, 1], p[b, 1]],
                "k-",
                lw=2,
            )
        ax.scatter(p[:, 0], p[:, 2], p[:, 1], c="tab:blue", s=12)
        ax.set_xlim(-0.8, 0.8)
        ax.set_ylim(-0.8, 0.8)
        ax.set_zlim(-1.2, 0.4)
        ax.set_title(title, fontsize=8)
        ax.axis("off")

    anim = animation.FuncAnimation(
        fig, draw, frames=len(poses), interval=1000 / fps
    )
    have_ffmpeg = shutil.which("ffmpeg") is not None
    if out_path.endswith(".mp4") and not have_ffmpeg:
        out_path = out_path[:-4] + ".gif"
    if out_path.endswith(".mp4"):
        anim.save(out_path, writer="ffmpeg", fps=fps)
        if audio is not None:
            _mux_audio(out_path, audio, sr)
    else:
        anim.save(out_path, writer="pillow", fps=fps)
    plt.close(fig)
    return out_path


def _mux_audio(video_path: str, audio: np.ndarray, sr: int) -> None:
    """Mux raw mono audio into the rendered video (train_utils.py tail)."""
    import wave

    wav_path = video_path + ".wav"
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    tmp = video_path + ".tmp.mp4"
    subprocess.run(
        ["ffmpeg", "-y", "-i", video_path, "-i", wav_path, "-c:v", "copy",
         "-c:a", "aac", tmp],
        check=True,
        capture_output=True,
    )
    os.replace(tmp, video_path)
    os.remove(wav_path)


def export_beat_bvh(
    euler_deg: np.ndarray,  # [T, 141] generated euler degrees
    template_bvh: str,
    out_path: str,
    joints: Optional[Sequence[str]] = None,
    fps: int = 15,
) -> str:
    """Write generated BEAT motion into a skeleton template BVH
    (data_tools.py:372-408 semantics: keep the template's hierarchy and
    non-generated channels, overwrite the generated joints' rotations)."""
    from ..data.beat import SPINE_NECK_141_JOINTS
    from ..data.bvh import parse_bvh, write_bvh

    joints = list(joints or SPINE_NECK_141_JOINTS)
    tpl = parse_bvh(template_bvh)
    t = len(euler_deg)
    frames = np.tile(tpl.frames[:1], (t, 1))

    col_of = {}
    for i, (j, c) in enumerate(tpl.channel_order):
        col_of[(j, c)] = i
    for ji, joint in enumerate(joints):
        rot_channels = [
            c for c in tpl.joints[joint].channels if c.endswith("rotation")
        ]
        order = tpl.rotation_order(joint)
        # our euler columns are in the joint's declared rotation order
        for k, axis in enumerate(order):
            ch = f"{axis}rotation"
            frames[:, col_of[(joint, ch)]] = euler_deg[:, ji * 3 + k]

    out = type(tpl)(
        joints=tpl.joints,
        root=tpl.root,
        frame_time=1.0 / fps,
        frames=frames,
        channel_order=tpl.channel_order,
    )
    write_bvh(out, out_path)
    return out_path

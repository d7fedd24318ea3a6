"""Quaternion helpers of the port's physics.

Counterparts of `sgqn_carla_tpu/physics/math3d.py`: `zaxis_to_quat_np`
(host numpy, used by `ModelBuilder`), `quat_to_mat` and
`quat_to_euler_xyz` (torch, batched). The 6D spatial algebra of the JAX
module is not needed: the scalar engine works on components (ops/v3.py),
the dense path on stacked (E, nl, 6) arrays (physics/dense.py).
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w,x,y,z) → (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Intrinsic x-y-z Euler angles (a, b, c), R = Rx(a)·Ry(b)·Rz(c), of
    unit quaternions (..., 4) → (..., 3): the chart of ModelBuilder's
    `add_free_root` hinge triplet (a random root orientation becomes the
    root hinge angles)."""
    R = quat_to_mat(q)
    b = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    c = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    a = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    return torch.stack([a, b, c], -1)


def zaxis_to_quat_np(z):
    """Host-side: quaternion rotating +z onto direction `z` (numpy, build time)."""
    z = np.asarray(z, dtype=np.float64)
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(up, z))
    if c > 1 - 1e-10:
        return np.array([1.0, 0.0, 0.0, 0.0])
    if c < -1 + 1e-10:
        return np.array([0.0, 1.0, 0.0, 0.0])  # 180° about x
    axis = np.cross(up, z)
    axis = axis / np.linalg.norm(axis)
    angle = np.arccos(c)
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])

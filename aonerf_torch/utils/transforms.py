"""Rotation and rigid-transform conversions on the host in NumPy (the
port's own copy of ``aonerf.utils.transforms``).

Conventions: quaternions are (w, x, y, z) unit; euler is intrinsic XYZ
radians; matrices are 3x3 row-major acting on column vectors.
"""

from typing import Tuple

import numpy as np


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation -> (..., 4) wxyz quaternion (w >= 0)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m, axis1=-2, axis2=-1)
    q = np.empty(m.shape[:-2] + (4,))
    # numerically-stable branch per element (Shepperd's method)
    it = np.nditer(t, flags=["multi_index"])
    for _ in it:
        idx = it.multi_index
        M = m[idx]
        tr = t[idx]
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q[idx] = [0.25 * s, (M[2, 1] - M[1, 2]) / s,
                      (M[0, 2] - M[2, 0]) / s, (M[1, 0] - M[0, 1]) / s]
        elif M[0, 0] >= M[1, 1] and M[0, 0] >= M[2, 2]:
            s = np.sqrt(1.0 + M[0, 0] - M[1, 1] - M[2, 2]) * 2
            q[idx] = [(M[2, 1] - M[1, 2]) / s, 0.25 * s,
                      (M[0, 1] + M[1, 0]) / s, (M[0, 2] + M[2, 0]) / s]
        elif M[1, 1] >= M[2, 2]:
            s = np.sqrt(1.0 + M[1, 1] - M[0, 0] - M[2, 2]) * 2
            q[idx] = [(M[0, 2] - M[2, 0]) / s, (M[0, 1] + M[1, 0]) / s,
                      0.25 * s, (M[1, 2] + M[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + M[2, 2] - M[0, 0] - M[1, 1]) * 2
            q[idx] = [(M[1, 0] - M[0, 1]) / s, (M[0, 2] + M[2, 0]) / s,
                      (M[1, 2] + M[2, 1]) / s, 0.25 * s]
    sign = np.where(q[..., :1] < 0, -1.0, 1.0)
    return q * sign


def axis_angle_to_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation: unit ``axis`` (3,) by ``angle`` rad -> (3, 3)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def matrix_to_axis_angle(m: np.ndarray) -> Tuple[np.ndarray, float]:
    """(3, 3) rotation -> (unit axis (3,), angle in [0, pi])."""
    m = np.asarray(m, np.float64)
    angle = float(np.arccos(np.clip((np.trace(m) - 1.0) / 2.0, -1.0, 1.0)))
    if angle < 1e-8:
        return np.array([1.0, 0.0, 0.0]), 0.0
    if np.pi - angle < 1e-6:  # near pi: axis from the symmetric part
        d = np.sqrt(np.clip((np.diag(m) + 1.0) / 2.0, 0.0, None))
        k = int(np.argmax(d))
        axis = d.copy()
        axis[(k + 1) % 3] = m[k, (k + 1) % 3] / (2 * d[k])
        axis[(k + 2) % 3] = m[k, (k + 2) % 3] / (2 * d[k])
        axis[k] = d[k]
        return axis / np.linalg.norm(axis), angle
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return v / (2.0 * np.sin(angle)), angle


def euler_xyz_to_matrix(rx: float, ry: float, rz: float) -> np.ndarray:
    """Intrinsic XYZ euler (rad) -> (3, 3): R = Rx @ Ry @ Rz."""
    cx, sx, cy, sy, cz, sz = (
        np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz)
    )
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def compose_c2w(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(3, 3) + (3,) -> (4, 4) homogeneous camera-to-world."""
    m = np.eye(4)
    m[:3, :3] = R
    m[:3, 3] = np.asarray(t)
    return m


def invert_se3(m: np.ndarray) -> np.ndarray:
    """Fast inverse of a (4, 4) rigid transform (R^T, -R^T t)."""
    m = np.asarray(m, np.float64)
    out = np.eye(4)
    out[:3, :3] = m[:3, :3].T
    out[:3, 3] = -m[:3, :3].T @ m[:3, 3]
    return out

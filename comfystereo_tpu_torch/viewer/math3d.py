"""Pure-numpy 3D math for the VR render loop (headset-free, fully testable).

The reference leans on pyopenxr's ``Matrix4x4f`` helpers
(native_viewer/core.py:493-516): an OpenGL projection from the headset's
asymmetric per-eye FOV and a rigid-body view matrix inverted from the eye
pose. We implement the same math directly so it can be unit-tested without
OpenXR and reused by any GL backend.

Conventions: right-handed, column vectors, OpenGL clip space (z in [-1, 1]).
Matrices are returned as row-major numpy (4, 4) float32; upload to GL with
``transpose=GL_TRUE`` or flatten column-major (``.flatten("F")``).
Quaternions are OpenXR layout ``(x, y, z, w)``.
"""
from __future__ import annotations

import numpy as np


def projection_from_fov(angle_left: float, angle_right: float,
                        angle_up: float, angle_down: float,
                        near: float = 0.1, far: float = 1000.0) -> np.ndarray:
    """OpenGL projection matrix from asymmetric FOV half-angles (radians).

    OpenXR supplies per-eye tangent-space bounds; left/down are typically
    negative. Equivalent to ``Matrix4x4f.create_projection_fov`` for the
    OPENGL graphics API (reference core.py:493-499).
    """
    tan_l, tan_r = np.tan(angle_left), np.tan(angle_right)
    tan_u, tan_d = np.tan(angle_up), np.tan(angle_down)
    w, h = tan_r - tan_l, tan_u - tan_d
    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = 2.0 / w
    proj[0, 2] = (tan_r + tan_l) / w
    proj[1, 1] = 2.0 / h
    proj[1, 2] = (tan_u + tan_d) / h
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -2.0 * far * near / (far - near)
    proj[3, 2] = -1.0
    return proj


def quat_to_mat3(q) -> np.ndarray:
    """Rotation matrix from an (x, y, z, w) unit quaternion."""
    x, y, z, w = (float(v) for v in q)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return np.array([
        [1.0 - yy - zz, xy - wz, xz + wy],
        [xy + wz, 1.0 - xx - zz, yz - wx],
        [xz - wy, yz + wx, 1.0 - xx - yy],
    ], dtype=np.float32)


def view_from_pose(position, orientation) -> np.ndarray:
    """View matrix = inverse of the rigid eye pose (reference core.py:502-508).

    ``position`` is an (x, y, z) translation, ``orientation`` an (x, y, z, w)
    quaternion; the pose maps eye space -> world, so the view matrix is the
    rigid-body inverse: ``[R^T | -R^T t]``.
    """
    rot = quat_to_mat3(orientation)
    t = np.asarray([float(v) for v in position], dtype=np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot.T
    view[:3, 3] = -rot.T @ t
    return view


def xr_pose_view(view) -> np.ndarray:
    """View matrix straight from an ``xr.View`` (pose.position/orientation
    expose .x/.y/.z[/.w])."""
    p = view.pose.position
    o = view.pose.orientation
    return view_from_pose((p.x, p.y, p.z), (o.x, o.y, o.z, o.w))


def xr_fov_projection(view, near: float = 0.1, far: float = 1000.0) -> np.ndarray:
    """Projection matrix straight from an ``xr.View``'s fov."""
    fov = view.fov
    return projection_from_fov(fov.angle_left, fov.angle_right,
                               fov.angle_up, fov.angle_down, near, far)


def mvp(projection: np.ndarray, view: np.ndarray,
        model: np.ndarray | None = None) -> np.ndarray:
    """Combined model-view-projection (model defaults to identity,
    reference core.py:510-511)."""
    out = projection @ view
    if model is not None:
        out = out @ model
    return np.ascontiguousarray(out, dtype=np.float32)

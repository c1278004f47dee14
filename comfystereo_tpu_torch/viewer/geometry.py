"""Projection-surface meshes for the VR viewer (pure numpy, testable).

Equivalents of the reference's UV-mapped surfaces
(native_viewer/geometry.py:9-187): 360-degree inward-facing sphere, flat
screen at seated eye height, curved arc screen, and a 180-degree dome. Each
returns interleaved [x, y, z, u, v] float32 vertices plus uint32 triangle
indices.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

EYE_HEIGHT = 1.2  # seated eye height in meters (reference flat screen)


def _grid_indices(rows: int, cols: int) -> np.ndarray:
    """Triangle indices for a (rows x cols) vertex grid."""
    r = np.arange(rows - 1)[:, None]
    c = np.arange(cols - 1)[None, :]
    v00 = (r * cols + c).ravel()
    v01 = v00 + 1
    v10 = v00 + cols
    v11 = v10 + 1
    tris = np.stack([
        np.stack([v00, v10, v01], axis=1),
        np.stack([v01, v10, v11], axis=1),
    ], axis=1).reshape(-1, 3)
    return tris.astype(np.uint32)


def create_sphere_mesh(segments: int = 60, rings: int = 40,
                       radius: float = 10.0) -> Tuple[np.ndarray, np.ndarray]:
    """Inward-facing 360-degree sphere with equirectangular UVs."""
    lon = np.linspace(0, 2 * np.pi, segments + 1)
    lat = np.linspace(-np.pi / 2, np.pi / 2, rings + 1)
    lon_g, lat_g = np.meshgrid(lon, lat)
    x = radius * np.cos(lat_g) * np.sin(lon_g)
    y = radius * np.sin(lat_g)
    z = -radius * np.cos(lat_g) * np.cos(lon_g)
    u = lon_g / (2 * np.pi)
    v = 1.0 - (lat_g / np.pi + 0.5)
    verts = np.stack([x, y, z, u, v], axis=-1).reshape(-1, 5).astype(np.float32)
    return verts, _grid_indices(rings + 1, segments + 1)


def create_flat_screen(width: float = 4.0, aspect: float = 16 / 9,
                       distance: float = 3.0, x_offset: float = 0.0,
                       y_offset: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat quad facing the viewer at seated eye height."""
    h = width / aspect
    x0, x1 = -width / 2 + x_offset, width / 2 + x_offset
    y0, y1 = EYE_HEIGHT - h / 2 + y_offset, EYE_HEIGHT + h / 2 + y_offset
    z = -distance
    verts = np.array([
        [x0, y0, z, 0.0, 1.0],
        [x1, y0, z, 1.0, 1.0],
        [x0, y1, z, 0.0, 0.0],
        [x1, y1, z, 1.0, 0.0],
    ], dtype=np.float32)
    idx = np.array([[0, 1, 2], [2, 1, 3]], dtype=np.uint32)
    return verts, idx


def create_curved_screen(width: float = 4.0, aspect: float = 16 / 9,
                         distance: float = 3.0, curve: float = 0.4,
                         segments: int = 20, rows: int = 10,
                         x_offset: float = 0.0, y_offset: float = 0.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontally curved arc screen; `curve` = arc strength (0..1)."""
    h = width / aspect
    arc = curve * np.pi  # total subtended angle
    theta = np.linspace(-arc / 2, arc / 2, segments + 1)
    radius = width / max(arc, 1e-6)
    ys = np.linspace(EYE_HEIGHT - h / 2 + y_offset,
                     EYE_HEIGHT + h / 2 + y_offset, rows + 1)
    th_g, y_g = np.meshgrid(theta, ys)
    x = radius * np.sin(th_g) + x_offset
    z = -(distance + radius * (1.0 - np.cos(th_g)) - radius * 0.0)
    u = (th_g + arc / 2) / max(arc, 1e-6)
    v = 1.0 - (y_g - (EYE_HEIGHT - h / 2 + y_offset)) / h
    verts = np.stack([x, y_g, z, u, v], axis=-1).reshape(-1, 5).astype(np.float32)
    return verts, _grid_indices(rows + 1, segments + 1)


def create_dome_180(segments: int = 60, rings: int = 40, radius: float = 10.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Front hemisphere (180-degree dome) with fisheye-style UVs."""
    lon = np.linspace(-np.pi / 2, np.pi / 2, segments + 1)
    lat = np.linspace(-np.pi / 2, np.pi / 2, rings + 1)
    lon_g, lat_g = np.meshgrid(lon, lat)
    x = radius * np.cos(lat_g) * np.sin(lon_g)
    y = radius * np.sin(lat_g)
    z = -radius * np.cos(lat_g) * np.cos(lon_g)
    u = lon_g / np.pi + 0.5
    v = 1.0 - (lat_g / np.pi + 0.5)
    verts = np.stack([x, y, z, u, v], axis=-1).reshape(-1, 5).astype(np.float32)
    return verts, _grid_indices(rings + 1, segments + 1)


def mesh_for_projection(projection, **kwargs):
    from .constants import Projection

    builders = {
        Projection.FLAT: create_flat_screen,
        Projection.CURVED: create_curved_screen,
        Projection.SPHERE_360: create_sphere_mesh,
        Projection.DOME_180: create_dome_180,
    }
    return builders[projection](**kwargs)

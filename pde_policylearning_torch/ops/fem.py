"""FEM helper operators of the Galerkin-transformer training pipeline.

Counterpart of `pde_policylearning_tpu/ops/fem.py`, the port's own copy
(numpy; reference: libs/models/utils_ft.py — quadpts:137 (triangle quadrature),
get_laplacian_1d:207 / get_mass_1d (P1 FEM matrices on variable meshes,
adapted from Long Chen's iFEM), get_distance_matrix:175).

Dense numpy implementations (the grids here are small; the reference
uses scipy sparse).
"""
from __future__ import annotations

import numpy as np


def quadpts(order: int = 2):
    """Triangle quadrature barycentric coordinates + weights
    (utils_ft.py:137-166)."""
    if order == 1:
        return np.array([[1 / 3, 1 / 3, 1 / 3]]), np.array([1.0])
    if order == 2:
        return (np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6],
                          [1 / 6, 1 / 6, 2 / 3]]),
                np.array([1 / 3, 1 / 3, 1 / 3]))
    if order == 3:
        return (np.array([[1 / 3, 1 / 3, 1 / 3], [0.6, 0.2, 0.2],
                          [0.2, 0.6, 0.2], [0.2, 0.2, 0.6]]),
                np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48]))
    b = np.array([[0.108103018168070, 0.445948490915965, 0.445948490915965],
                  [0.445948490915965, 0.108103018168070, 0.445948490915965],
                  [0.445948490915965, 0.445948490915965, 0.108103018168070],
                  [0.816847572980459, 0.091576213509771, 0.091576213509771],
                  [0.091576213509771, 0.816847572980459, 0.091576213509771],
                  [0.091576213509771, 0.091576213509771, 0.816847572980459]])
    w = np.array([0.223381589678011] * 3 + [0.109951743655322] * 3)
    return b, w


def get_laplacian_1d(node, normalize: bool = True):
    """P1 stiffness matrix on a (possibly graded) 1-D mesh
    (utils_ft.py:207-262), dense."""
    if isinstance(node, int):
        node = np.linspace(0, 1, node)
    node = np.asarray(node, np.float64)
    N = len(node)
    h = node[1:] - node[:-1]
    A = np.zeros((N, N))
    for e in range(N - 1):
        k = 1.0 / h[e]
        A[e, e] += k
        A[e + 1, e + 1] += k
        A[e, e + 1] -= k
        A[e + 1, e] -= k
    if normalize:
        d = np.sqrt(np.abs(np.diag(A)))
        d[d == 0] = 1.0
        A = A / d[:, None] / d[None, :]
    return A


def get_mass_1d(node, normalize: bool = False):
    """P1 mass matrix on a 1-D mesh (utils_ft.py get_mass_1d), dense."""
    if isinstance(node, int):
        node = np.linspace(0, 1, node)
    node = np.asarray(node, np.float64)
    N = len(node)
    h = node[1:] - node[:-1]
    M = np.zeros((N, N))
    for e in range(N - 1):
        M[e, e] += h[e] / 3
        M[e + 1, e + 1] += h[e] / 3
        M[e, e + 1] += h[e] / 6
        M[e + 1, e] += h[e] / 6
    if normalize:
        d = np.sqrt(np.abs(np.diag(M)))
        M = M / d[:, None] / d[None, :]
    return M


def get_distance_matrix(node, graph: bool = False):
    """Inverse distance matrices (utils_ft.py:175-205): (N, N, 2) with
    1/d and 1/d^2 channels (diagonal zeroed)."""
    node = np.asarray(node, np.float64)
    if node.ndim == 1:
        node = node[:, None]
    diff = node[:, None, :] - node[None, :, :]
    d = np.linalg.norm(diff, axis=-1)
    with np.errstate(divide="ignore"):
        inv = np.where(d > 0, 1.0 / d, 0.0)
        inv2 = np.where(d > 0, 1.0 / d ** 2, 0.0)
    return np.stack([inv, inv2], axis=-1)


def apply_periodic_boundary(arr, mod_length: int = 3, axis: int = 0):
    """Wrap the first `mod_length` slices onto the end (libs/env_util.py)."""
    arr = np.asarray(arr)
    head = np.take(arr, range(mod_length), axis=axis)
    return np.concatenate([arr, head], axis=axis)

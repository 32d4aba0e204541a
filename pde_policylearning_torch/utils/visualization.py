"""Host-side plots: colormaps, videos, pressure and velocity fields.

Counterpart of `pde_policylearning_tpu/utils/visualization.py` (the
port's own copy; reference: libs/visualization.py: matrix2image (:8),
save_images_to_video (:26, cv2), visualize_pressure_speed (:40, contour
and quiver), vis_diagram (:74, wandb)).  imageio and matplotlib take cv2's
place; each function warns and falls back where its package is missing.
Tensors are read back to the host first.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def matrix2image(matrix, vmin=None, vmax=None, cmap="viridis"):
    """Colormap a 2-D array to uint8 RGB (visualization.py:8)."""
    m = _host(matrix).astype(np.float64)
    vmin = m.min() if vmin is None else vmin
    vmax = m.max() if vmax is None else vmax
    norm = np.clip((m - vmin) / (vmax - vmin + 1e-12), 0, 1)
    try:
        import matplotlib
        rgba = matplotlib.colormaps[cmap](norm)
        return (rgba[..., :3] * 255).astype(np.uint8)
    except Exception:
        g = (norm * 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)


def save_images_to_video(images: Sequence[np.ndarray], path: str,
                         fps: int = 10):
    """Write an image sequence to a video or gif (visualization.py:26);
    the path, or None where imageio cannot."""
    try:
        import imageio
        imageio.mimsave(path, [_host(i) for i in images], fps=fps)
        return path
    except Exception as e:
        warnings.warn(f"save_images_to_video unavailable: {e}")
        return None


def visualize_pressure_speed(pressure, pressure_min=None, pressure_max=None,
                             speed_horizontal=None, speed_vertical=None,
                             vis_img=False, vis_name="field",
                             quiver_scale=0.03, x_sample_interval=1,
                             y_sample_interval=1, v_flip=True):
    """A pressure contour with a velocity quiver as an RGB array
    (visualization.py:40-72)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:
        warnings.warn(f"matplotlib unavailable: {e}")
        return matrix2image(pressure, pressure_min, pressure_max)
    fig, ax = plt.subplots(figsize=(4, 4), dpi=72)
    p = _host(pressure)
    ax.contourf(p, levels=20, vmin=pressure_min, vmax=pressure_max,
                cmap="RdBu_r")
    if speed_horizontal is not None and speed_vertical is not None:
        u = _host(speed_horizontal)[::y_sample_interval, ::x_sample_interval]
        v = _host(speed_vertical)[::y_sample_interval, ::x_sample_interval]
        ax.quiver(np.arange(0, p.shape[1], x_sample_interval),
                  np.arange(0, p.shape[0], y_sample_interval),
                  u, v, scale=1.0 / max(quiver_scale, 1e-6))
    if v_flip:
        ax.invert_yaxis()
    ax.set_title(vis_name)
    ax.axis("off")
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def vis_diagram(data: dict, use_wandb: bool = False):
    """The first sample of 'x', 'pred' and 'y' as images
    (visualization.py:74), pushed to wandb where asked and importable."""
    panels = {name: matrix2image(_host(data[name])[0].squeeze())
              for name in ("x", "pred", "y") if name in data}
    if use_wandb:
        try:
            import wandb
            wandb.log({k: wandb.Image(v) for k, v in panels.items()})
        except Exception as e:
            warnings.warn(f"wandb unavailable: {e}")
    return panels

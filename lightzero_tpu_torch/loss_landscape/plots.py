"""Loss-landscape plotting and export (``lightzero_tpu/loss_landscape/plots.py``;
role of reference lzero/loss_landscape/landscape_plots.py and its h5->vtp
exporter): render the .npz surfaces that ``loss_landscape_api`` saves as
PNGs, export 2-D surfaces as a ParaView-readable VTK file, and project a
training trajectory of checkpoints onto the 2-D direction plane (reference
core/direction.py:242-284, the PCA directions). Host-side numpy and
matplotlib; a checkpoint is a model, or a dict of tensors keyed as its
``named_parameters``."""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def plot_1d(alphas, loss, out_path: str, title: str = "loss landscape (1d)") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.asarray(alphas), np.asarray(loss), marker="o", ms=3)
    ax.set_xlabel("alpha")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_2d_contour(
    alphas,
    betas,
    loss,
    out_path: str,
    title: str = "loss landscape (2d)",
    levels: int = 25,
    trajectory: Optional[np.ndarray] = None,
) -> str:
    """Filled contour + line contour of the 2D surface; optionally overlays
    a projected (alpha, beta) training trajectory (reference
    landscape_plots plot_contour_trajectory)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    A, Bm = np.meshgrid(np.asarray(betas), np.asarray(alphas))
    Z = np.asarray(loss)
    fig, ax = plt.subplots(figsize=(6, 5))
    cf = ax.contourf(Bm, A, Z, levels=levels, cmap="viridis")
    ax.contour(Bm, A, Z, levels=levels, colors="k", linewidths=0.3, alpha=0.4)
    fig.colorbar(cf, ax=ax, label="loss")
    if trajectory is not None and len(trajectory):
        t = np.asarray(trajectory)
        ax.plot(t[:, 0], t[:, 1], "r.-", lw=1.2, ms=4, label="training trajectory")
        ax.plot(t[-1, 0], t[-1, 1], "r*", ms=12)
        ax.legend(loc="best")
    ax.set_xlabel("alpha (d1)")
    ax.set_ylabel("beta (d2)")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def export_vtk(alphas, betas, loss, out_path: str, log_scale: bool = True) -> str:
    """Write the 2D surface as a legacy-ASCII VTK STRUCTURED_GRID readable
    by ParaView (role of the reference's h5->vtp conversion step). Height =
    loss (optionally log1p-scaled, the reference's default for peaky
    surfaces)."""
    a = np.asarray(alphas, np.float64)
    b = np.asarray(betas, np.float64)
    z = np.asarray(loss, np.float64)
    zs = np.log1p(z - z.min()) if log_scale else z
    nx, ny = len(a), len(b)
    with open(out_path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("lightzero_tpu loss landscape\nASCII\n")
        f.write("DATASET STRUCTURED_GRID\n")
        f.write(f"DIMENSIONS {ny} {nx} 1\n")
        f.write(f"POINTS {nx * ny} double\n")
        for i in range(nx):
            for j in range(ny):
                f.write(f"{a[i]:.6g} {b[j]:.6g} {zs[i, j]:.6g}\n")
        f.write(f"POINT_DATA {nx * ny}\n")
        f.write("SCALARS loss double 1\nLOOKUP_TABLE default\n")
        for i in range(nx):
            for j in range(ny):
                f.write(f"{z[i, j]:.6g}\n")
    return out_path


# ---------------- trajectory projection ------------------------------------
def _tensors(params) -> Dict[str, torch.Tensor]:
    """A model's parameters by name, or the dict itself."""
    if hasattr(params, "named_parameters"):
        return {k: v.detach() for k, v in params.named_parameters()}
    return dict(params)


def _flatten(params, names: Sequence[str]) -> np.ndarray:
    """The tensors ``names`` of a model or dict as one float64 vector."""
    params = _tensors(params)
    return np.concatenate([np.asarray(torch.as_tensor(params[k]).cpu(), np.float64).ravel()
                           for k in names])


def pca_directions(checkpoints: Sequence, final_params):
    """Top-2 PCA directions of (ckpt_i - final) parameter differences
    (reference core/direction.py:242-284 setup_PCA_directions): returns
    (d1, d2) as flat float64 vectors, in the order of ``final_params``'s
    tensors, plus the explained-variance ratios."""
    names = list(_tensors(final_params))
    base = _flatten(final_params, names)
    M = np.stack([_flatten(c, names) - base for c in checkpoints])  # (N, P)
    # economy SVD on the (N, P) matrix: N is small (number of checkpoints)
    _, s, vt = np.linalg.svd(M, full_matrices=False)
    var = s**2 / max(float(np.sum(s**2)), 1e-30)
    return vt[0], vt[1] if len(vt) > 1 else np.zeros_like(vt[0]), var[:2]


def project_trajectory(checkpoints: Sequence, final_params, d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Project each checkpoint's offset from final_params onto (d1, d2)
    (reference core/direction.py project_trajectory): returns (N, 2)
    [alpha, beta] coordinates."""
    names = list(_tensors(final_params))
    base = _flatten(final_params, names)
    n1 = d1 / max(np.linalg.norm(d1), 1e-30)
    n2 = d2 / max(np.linalg.norm(d2), 1e-30)
    out = []
    for c in checkpoints:
        diff = _flatten(c, names) - base
        out.append([float(diff @ n1), float(diff @ n2)])
    return np.asarray(out)


def unflatten_like(flat: np.ndarray, model) -> Dict[str, torch.Tensor]:
    """A flat float64 vector cut into tensors of the shapes, dtypes and
    device of ``model``'s parameters (or a dict of tensors), keyed as they
    are: a direction for ``loss_surface_2d`` from ``pca_directions``."""
    out, i = {}, 0
    for name, leaf in _tensors(model).items():
        n = leaf.numel()
        out[name] = torch.as_tensor(flat[i:i + n].reshape(tuple(leaf.shape)),
                                    dtype=leaf.dtype, device=leaf.device)
        i += n
    return out


def render_landscape_dir(out_dir: str, trajectory: Optional[np.ndarray] = None) -> List[str]:
    """Render every saved surface npz in ``out_dir`` into PNG + VTK files
    (one-call equivalent of the reference's plotting entrypoints)."""
    produced = []
    p1 = os.path.join(out_dir, "loss_surface_1d.npz")
    if os.path.exists(p1):
        d = np.load(p1)
        produced.append(plot_1d(d["alphas"], d["loss"], os.path.join(out_dir, "loss_surface_1d.png")))
    p2 = os.path.join(out_dir, "loss_surface_2d.npz")
    if os.path.exists(p2):
        d = np.load(p2)
        produced.append(
            plot_2d_contour(
                d["alphas"], d["betas"], d["loss"],
                os.path.join(out_dir, "loss_surface_2d.png"), trajectory=trajectory,
            )
        )
        produced.append(
            export_vtk(d["alphas"], d["betas"], d["loss"], os.path.join(out_dir, "loss_surface_2d.vtk"))
        )
    return produced

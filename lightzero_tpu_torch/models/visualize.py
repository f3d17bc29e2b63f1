"""World-model visualisation (``lightzero_tpu/models/visualize.py``; role
of reference lzero/model/unizero_world_models/visualize_utils.py and
attention_map.py): reconstruction grids, latent t-SNE/PCA maps and
transformer attention maps, as PNGs.

Host-side numpy and matplotlib, on arrays already read off the device.
Attention maps come from ``capture_attention`` (in
``models/unizero_world_model/transformer.py``) around a full-sequence
forward, the role of flax's ``sow("intermediates", "attention", att)``::

    with capture_attention(model.transformer) as maps:
        model.train_forward(obs, actions)
    visualize_attention_maps([m.cpu().numpy() for m in maps], "attention.png")
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def visualize_reconstruction(
    original: np.ndarray,
    reconstructed: np.ndarray,
    out_path: str,
    max_items: int = 8,
    rewards: Optional[np.ndarray] = None,
    values: Optional[np.ndarray] = None,
) -> str:
    """Two-row grid: originals on top, decoder reconstructions below
    (reference visualize_reconstruction_v1/v2). Arrays: (T, H, W, C) in
    [0, 1]; C==1 or stacked frames are collapsed for display."""
    plt = _plt()
    original = np.asarray(original)
    reconstructed = np.asarray(reconstructed)
    n = min(max_items, original.shape[0])

    def show(ax, img):
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[-1] not in (1, 3):
            img = img.mean(axis=-1, keepdims=True)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        ax.imshow(np.clip(img, 0, 1), cmap="gray" if img.ndim == 2 else None)
        ax.axis("off")

    fig, axes = plt.subplots(2, n, figsize=(1.6 * n, 3.4))
    axes = np.atleast_2d(axes)
    for i in range(n):
        show(axes[0][i], original[i])
        show(axes[1][i], reconstructed[i])
        title = []
        if rewards is not None:
            title.append(f"r={float(rewards[i]):.2f}")
        if values is not None:
            title.append(f"v={float(values[i]):.2f}")
        if title:
            axes[0][i].set_title(" ".join(title), fontsize=7)
    axes[0][0].set_ylabel("obs")
    axes[1][0].set_ylabel("recon")
    _ensure_dir(out_path)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def visualize_attention_maps(
    attentions: Sequence[np.ndarray],
    out_path: str,
    layer_names: Optional[Sequence[str]] = None,
) -> str:
    """Heatmap grid of per-layer, per-head attention matrices (reference
    attention_map.py:visualize_attention_maps). Each entry: (B, heads, T, T)
    or (heads, T, T); batch element 0 is shown."""
    plt = _plt()
    mats = []
    names = []
    for li, att in enumerate(attentions):
        a = np.asarray(att)
        if a.ndim == 4:
            a = a[0]
        for h in range(a.shape[0]):
            mats.append(a[h])
            base = layer_names[li] if layer_names else f"layer{li}"
            names.append(f"{base}/head{h}")
    cols = min(4, len(mats))
    rows = (len(mats) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).reshape(rows, cols)
    for i, (m, name) in enumerate(zip(mats, names)):
        ax = axes[i // cols][i % cols]
        ax.imshow(m, cmap="viridis", aspect="auto")
        ax.set_title(name, fontsize=7)
        ax.axis("off")
    for j in range(len(mats), rows * cols):
        axes[j // cols][j % cols].axis("off")
    _ensure_dir(out_path)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_latent_map(
    embeddings: np.ndarray,
    out_path: str,
    timesteps: Optional[np.ndarray] = None,
    method: str = "pca",
) -> str:
    """2-D map of latent obs embeddings colored by timestep (reference
    plot_latent_tsne_*; PCA by default — sklearn's t-SNE is used when
    available and ``method='tsne'``)."""
    plt = _plt()
    X = np.asarray(embeddings).reshape(len(embeddings), -1)
    if method == "tsne":
        try:
            from sklearn.manifold import TSNE

            pts = TSNE(n_components=2, init="pca", perplexity=min(30, max(2, len(X) // 4))).fit_transform(X)
        except Exception:
            method = "pca"
    if method != "tsne":
        Xc = X - X.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(Xc, full_matrices=False)
        pts = Xc @ vt[:2].T
    t = np.arange(len(X)) if timesteps is None else np.asarray(timesteps)
    fig, ax = plt.subplots(figsize=(5, 4))
    sc = ax.scatter(pts[:, 0], pts[:, 1], c=t, cmap="viridis", s=14)
    fig.colorbar(sc, ax=ax, label="timestep")
    ax.set_title(f"latent map ({method})")
    _ensure_dir(out_path)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path

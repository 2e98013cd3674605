"""Point-cloud and embedding visualisation tool (numpy only).

Counterpart of coda_neurips2023_tpu/vis_color_pc.py, the reference's
repo-root `vis_color_pc.py` (t-SNE and an open3d viewer) without GUI
dependencies: it writes an ascii PLY of a point cloud (with its colours
where the cloud has 6 channels, RGB in [0, 1]) and a wireframe OBJ of its
boxes, viewable in any mesh tool, and a t-SNE projection of CLIP embeddings
to a PNG.  scikit-learn and matplotlib are imported only by
`vis_embeddings_tsne`: without scikit-learn it prints a note and writes
nothing; without matplotlib it saves the projection as `tsne_proj.npy`.

Usage:
  python -m coda_neurips2023_tpu_torch.vis_color_pc --pc scene_pc.npz --bbox scene_bbox.npy --out out/
  python -m coda_neurips2023_tpu_torch.vis_color_pc --embeddings feats.npy --labels labels.npy --out out/
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from coda_neurips2023_tpu_torch.ops.box_ops import get_3d_box_batch_xyz_np
from coda_neurips2023_tpu_torch.utils.ply import write_bbox_obj, write_ply


def vis_pointcloud(pc_path: str, out_dir: str, bbox_path: str = None):
    """`<name>.ply` from a (N, 3 or 6) cloud (.npz key "pc", or .npy), and
    `<name>_boxes.obj` from a (K, >= 7) box file: cx cy cz, half extents,
    heading."""
    os.makedirs(out_dir, exist_ok=True)
    pc = np.load(pc_path)["pc"] if pc_path.endswith(".npz") else np.load(pc_path)
    colors = None
    if pc.shape[1] >= 6:
        colors = np.clip(pc[:, 3:6] * 255, 0, 255).astype(np.uint8)
    name = os.path.splitext(os.path.basename(pc_path))[0]
    write_ply(pc[:, :3], os.path.join(out_dir, name + ".ply"), colors)
    if bbox_path and os.path.exists(bbox_path):
        boxes = np.load(bbox_path)
        corners = get_3d_box_batch_xyz_np(boxes[None, :, 3:6] * 2.0, boxes[None, :, 6],
                                          boxes[None, :, 0:3])[0]
        write_bbox_obj(corners, os.path.join(out_dir, name + "_boxes.obj"))


def vis_embeddings_tsne(emb_path: str, out_dir: str, labels_path: str = None):
    """`<name>_tsne.png`: a 2-D t-SNE of the (N, D) embeddings, coloured by
    the labels where given."""
    os.makedirs(out_dir, exist_ok=True)
    emb = np.load(emb_path)
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        print("sklearn unavailable; skipping t-SNE")
        return
    proj = TSNE(n_components=2, init="pca").fit_transform(emb)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        labels = np.load(labels_path) if labels_path else None
        plt.figure(figsize=(8, 8))
        plt.scatter(proj[:, 0], proj[:, 1], c=labels, s=4, cmap="tab20")
        name = os.path.splitext(os.path.basename(emb_path))[0]
        plt.savefig(os.path.join(out_dir, name + "_tsne.png"), dpi=150)
    except ImportError:
        np.save(os.path.join(out_dir, "tsne_proj.npy"), proj)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pc", default=None)
    p.add_argument("--bbox", default=None)
    p.add_argument("--embeddings", default=None)
    p.add_argument("--labels", default=None)
    p.add_argument("--out", default="vis_out")
    args = p.parse_args(argv)
    if args.pc:
        vis_pointcloud(args.pc, args.out, args.bbox)
    if args.embeddings:
        vis_embeddings_tsne(args.embeddings, args.out, args.labels)


if __name__ == "__main__":
    main()

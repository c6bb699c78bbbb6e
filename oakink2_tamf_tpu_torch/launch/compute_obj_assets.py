"""Precompute per-object point clouds and PointBERT embeddings (port of
scripts/compute_obj_assets.py).

Replaces the reference's downloaded obj_pointcloud/ + obj_embedding/ assets
(README.md:118-126; config/obj_pointcloud.yml, obj_embedding.yml): samples
`--n_points` surface points per `<obj_id>.obj` mesh (seed 0) and embeds them
with models/pointbert.PointTransformer at its default configuration, in
batches of `--batch_size` clouds on `--device` (the JAX script embeds one
cloud at a time; in eval mode each cloud is embedded on its own, so the
batch changes only float32 rounding).

  python -m oakink2_tamf_tpu_torch.launch.compute_obj_assets --mesh_dir <dir> \
      --out_pointcloud common/obj_pointcloud --out_embedding common/obj_embedding \
      [--pointbert_ckpt path.pt] [--device cpu] [--batch_size 16] --commit

`--pointbert_ckpt`: a port train checkpoint ({step, model, optimizer},
runtime/ckpt.py) loads through runtime/ckpt; any other .pt/.pth is the
reference's Point-BERT checkpoint (models/pointbert.load_pointbert_checkpoint).
Nothing is written without --commit.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .._device import resolve_device
from ..models.pointbert import PointBertConfig, PointTransformer, load_pointbert_checkpoint
from ..runtime.ckpt import load_model_weights, read_model_state_dict
from ..utils.mesh_io import load_obj, sample_surface


def load_weights(model: PointTransformer, path: str) -> str:
    """Load `path` into `model`; -> which kind of checkpoint it was."""
    if not path.endswith((".pt", ".pth")):
        raise ValueError(f"--pointbert_ckpt {path}: not a torch checkpoint (.pt or .pth)")
    _, own = read_model_state_dict(path)
    if own:
        load_model_weights(model, path)
        return "port checkpoint"
    load_pointbert_checkpoint(path, model)
    return "ported reference Point-BERT torch checkpoint"


def main(argv=None) -> list[str]:
    """-> the object ids, in the order they were embedded."""
    p = argparse.ArgumentParser()
    p.add_argument("--mesh_dir", required=True)
    p.add_argument("--out_pointcloud", default="common/obj_pointcloud")
    p.add_argument("--out_embedding", default="common/obj_embedding")
    p.add_argument("--n_points", type=int, default=8192)
    p.add_argument("--pointbert_ckpt", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--commit", action="store_true")
    args = p.parse_args(argv)
    if args.batch_size < 1:
        p.error("--batch_size must be at least 1")
    device = resolve_device(args.device)

    meshes = sorted(f for f in os.listdir(args.mesh_dir) if f.endswith(".obj"))
    print(f"{len(meshes)} meshes in {args.mesh_dir}")

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = PointTransformer(PointBertConfig())
    if args.pointbert_ckpt:
        kind = load_weights(model, args.pointbert_ckpt)
        print(f"{kind} {args.pointbert_ckpt}")
    else:
        print(
            "WARNING: no --pointbert_ckpt given — embeddings come from RANDOM-INIT "
            "weights and will NOT match the reference's downloaded obj_embedding/ assets"
        )
    model.to(device).eval().requires_grad_(False)

    if args.commit:
        os.makedirs(args.out_pointcloud, exist_ok=True)
        os.makedirs(args.out_embedding, exist_ok=True)

    oids = [os.path.splitext(f)[0] for f in meshes]
    bs = args.batch_size
    for start in range(0, len(meshes), bs):
        clouds = []
        for fname in meshes[start : start + bs]:
            verts, faces = load_obj(os.path.join(args.mesh_dir, fname))
            clouds.append(sample_surface(verts, faces, args.n_points))
        with torch.no_grad():
            embs = model(torch.from_numpy(np.stack(clouds)).to(device)).cpu().numpy()
        for oid, pts, emb in zip(oids[start : start + bs], clouds, embs):
            if args.commit:
                np.savez(os.path.join(args.out_pointcloud, f"{oid}.npz"), point=pts)
                np.save(os.path.join(args.out_embedding, f"{oid}.npy"), emb)
            print(f"{oid}: {pts.shape} points, {emb.shape} embedding")
    return oids


if __name__ == "__main__":
    main()

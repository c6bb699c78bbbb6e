"""Debug/visual check of R: refine a few samples and render GT vs sample vs
refined overlays and h2o heatmap strips (port of scripts/debug_refine.py;
the reference's script/debug/debug_refine_data.py and
debug_refine_sample.py:207-299, headless).

    python -m oakink2_tamf_tpu_torch.launch.debug_refine --cfg config/synthetic_smoke.yml \
        [--model_filepath R.pt] [--sample_dir <sample_g's out dir>] [--n_samples 2] \
        [--split test] [--html true] [--runtime.device cpu] --out tmp/debug_refine

The input is data/adaptors.GeneratedPoseReprSampleAdaptor over the split
with --sample_dir, else GaussianPerturbSampleAdaptor(GT, sigma in
(0.02, 0.1), seed 0). The batch is collated at data.max_nobj slots of
data.n_obj_points points, and R's deterministic forward with the target
branch (models/refine_r.refine_forward, every frame searched) runs on the
run's device, its h2o searches on the kernels' route for that cloud size.
A .pt is a reference state_dict (run under "gelu_exact") or a port train
checkpoint, a .ckpt the JAX package's (launch/common.activation_for_checkpoint,
runtime/ckpt);
without one R is randomly initialised from seed 0.

Per segment it writes
  refine_<i>_overlay.png  3 skeleton strips: sample vs GT, refined vs GT,
                          refined joints with the moved object cloud
  refine_<i>_h2o.png      heatmaps of the 778-vert h2o distances over time
                          for sample / refined / GT target, with per-frame
                          mean curves
(and refine_<i>.html with --html), and prints the sample -> refined joint
MPJPE and mean |h2o - target| in mm.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..core import mano as M
from ..data.adaptors import GaussianPerturbSampleAdaptor, GeneratedPoseReprSampleAdaptor
from ..data.collate import SegmentCollate
from ..eval.metrics import transf_merge_obj_pointcloud
from ..models.refine_r import refine_forward, stack_mano_models
from ..runtime.ckpt import load_model_weights
from ..runtime.config import ConfigRegistry
from ..viz.html_viewer import export_html_viewer
from ..viz.render import render_sequence_grid
from . import common, param
from .train_r import build_refine_net


def render_h2o_strip(h2o_by_name: dict, out_path: str, vmax: float = 0.05) -> None:
    """Heatmaps [L, 778] per variant + per-frame mean curves in one figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(h2o_by_name)
    fig, axes = plt.subplots(n + 1, 1, figsize=(10, 2.2 * (n + 1)))
    for ax, (name, h2o) in zip(axes[:-1], h2o_by_name.items()):
        im = ax.imshow(np.asarray(h2o).T, aspect="auto", origin="lower", cmap="viridis", vmin=0.0, vmax=vmax)
        ax.set_ylabel(f"{name}\nvert")
        fig.colorbar(im, ax=ax, fraction=0.02)
    for name, h2o in h2o_by_name.items():
        axes[-1].plot(np.mean(np.asarray(h2o), axis=1), label=name)
    axes[-1].set_xlabel("frame")
    axes[-1].set_ylabel("mean h2o [m]")
    axes[-1].legend(fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def _overlay(figs, path: str) -> None:
    """The figures' canvases stacked top to bottom into one PNG."""
    import matplotlib.pyplot as plt
    from PIL import Image

    rows = []
    for f in figs:
        f.canvas.draw()
        rows.append(np.asarray(f.canvas.buffer_rgba())[..., :3])
        plt.close(f)
    w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0)), constant_values=255) for r in rows]
    Image.fromarray(np.concatenate(rows, axis=0)).save(path)


def main(argv=None) -> dict[str, np.ndarray]:
    """-> refine_forward's outputs for the batch, as numpy arrays."""
    reg = ConfigRegistry("debug_refine")
    param.reg_base_param(reg)
    param.reg_mano_param(reg)
    param.reg_model_param(reg)
    reg.register("model_filepath", category=str, default="")
    reg.register("sample_dir", category=str, default="")
    reg.register("out", category=str, default="tmp/debug_refine")
    reg.register("n_samples", category=int, default=2)
    reg.register("split", category=str, default="test")
    reg.register("html", category=bool, default=False,
                 desc="also export an interactive refine_<i>.html viewer per segment")
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, argv)
    device = common.run_device(reg)

    base = common.build_dataset(reg, reg.select("split"))
    if reg.select("sample_dir"):
        dataset = GeneratedPoseReprSampleAdaptor(base, [reg.select("sample_dir")])
    else:
        dataset = GaussianPerturbSampleAdaptor(base, (0.02, 0.1), seed=0)
        print("no --sample_dir: refining Gaussian-perturbed GT", file=sys.stderr)

    model_fp = reg.select("model_filepath")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = build_refine_net(reg, activation=common.activation_for_checkpoint(reg, model_fp))
    if model_fp:
        load_model_weights(net, model_fp)
        print(f"loaded refine model from {model_fp}", file=sys.stderr)
    else:
        print("no --model_filepath: running with FRESH random params", file=sys.stderr)
    net.to(device).eval().requires_grad_(False)
    mano_path = reg.select("mano").get("mano_path") or None
    mano_stack = stack_mano_models(
        M.get_mano_model(mano_path, "right"), M.get_mano_model(mano_path, "left"), device
    )

    n = min(int(reg.select("n_samples")), len(dataset))
    dcfg = reg.select("data")
    collate = SegmentCollate(max_nobj=int(dcfg.get("max_nobj", 4)), n_obj_points=int(dcfg.get("n_obj_points", 2048)))
    batch = collate([dataset[i] for i in range(n)])
    db = common.device_batch(batch, device)
    with torch.inference_mode():
        out = {k: v.cpu().numpy() for k, v in refine_forward(net, mano_stack, db, with_target=True).items()}

    out_dir = reg.select("out")
    L = db["sample_pose_repr"].shape[1]
    for i in range(n):
        seg_len = int(np.asarray(batch["mask"][i]).sum()) if "mask" in batch else L
        sl = slice(0, max(seg_len, 1))
        merged = transf_merge_obj_pointcloud(batch["obj_points"][i], batch["obj_traj"][i]).numpy()
        t_j, s_j, r_j = (out[f"{k}_hand_joints"][i] for k in ("target", "sample", "refine"))
        os.makedirs(out_dir, exist_ok=True)
        fp = os.path.join(out_dir, f"refine_{i:03d}_overlay.png")
        _overlay([
            render_sequence_grid(s_j[sl], joints_ref_seq=t_j[sl]),
            render_sequence_grid(r_j[sl], joints_ref_seq=t_j[sl]),
            render_sequence_grid(r_j[sl], obj_points_seq=merged[sl]),
        ], fp)
        h2o = {k: out[f"{k}_h2o_dist"][i][sl] for k in ("sample", "refine", "target")}
        render_h2o_strip({"sample": h2o["sample"], "refined": h2o["refine"], "target": h2o["target"]},
                         os.path.join(out_dir, f"refine_{i:03d}_h2o.png"))
        if reg.select("html"):
            hp = export_html_viewer(
                os.path.join(out_dir, f"refine_{i:03d}.html"),
                [
                    {"name": "target (GT)", "pos": t_j[sl], "kind": "skeleton", "color": "#999999", "alpha": 0.7},
                    {"name": "sample (G)", "pos": s_j[sl], "kind": "skeleton", "color": "#1f77b4"},
                    {"name": "refined (R)", "pos": r_j[sl], "kind": "skeleton", "color": "#2ca02c"},
                    {"name": "object", "pos": merged[sl], "kind": "cloud", "color": "#ff7f0e", "alpha": 0.5},
                ],
                title=f"refine segment {i}",
            )
            print(f"segment {i}: interactive viewer {hp}")

        mpjpe_s = float(np.linalg.norm(s_j[sl] - t_j[sl], axis=-1).mean())
        mpjpe_r = float(np.linalg.norm(r_j[sl] - t_j[sl], axis=-1).mean())
        h2o_s = float(np.abs(h2o["sample"] - h2o["target"]).mean())
        h2o_r = float(np.abs(h2o["refine"] - h2o["target"]).mean())
        print(
            f"segment {i}: MPJPE sample {mpjpe_s * 1e3:.2f} -> refined "
            f"{mpjpe_r * 1e3:.2f} mm | mean|h2o-target| {h2o_s * 1e3:.2f} -> "
            f"{h2o_r * 1e3:.2f} mm | wrote {fp}"
        )
    return out


if __name__ == "__main__":
    main()

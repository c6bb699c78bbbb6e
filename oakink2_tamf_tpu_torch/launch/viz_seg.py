"""Render raw dataset segments (port of scripts/viz_seg.py; the reference's
script/viz_seg.py, headless).

    python -m oakink2_tamf_tpu_torch.launch.viz_seg --cfg config/synthetic_smoke.yml \
        --out tmp/viz_seg [--indices 0,1,2] [--split train] [--gif true] [--html true] \
        [--runtime.device cpu]

Per index, the GT hand's joints (MANO of the segment's pose_repr on the
run's device) over its true length with the object clouds moved along
their trajectories: seg_<idx>.png, and with --gif / --html seg_<idx>.gif /
seg_<idx>.html.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core import mano as M
from ..eval.metrics import transf_merge_obj_pointcloud
from ..models.refine_r import batch_recover_mano, stack_mano_models
from ..runtime.config import ConfigRegistry
from ..viz.html_viewer import export_html_viewer
from ..viz.render import render_sequence_grid, save_sequence_gif
from . import common, param


def main(argv=None) -> list[str]:
    """-> the PNG paths written, one per index."""
    reg = ConfigRegistry("viz_seg")
    param.reg_base_param(reg)
    param.reg_mano_param(reg)
    reg.register("out", category=str, default="tmp/viz_seg")
    reg.register("indices", category=int, is_list=True, default=[0])
    reg.register("split", category=str, default="train")
    reg.register("gif", category=bool, default=False)
    reg.register("html", category=bool, default=False,
                 desc="also export an interactive seg_<i>.html viewer")
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, argv)
    device = common.run_device(reg)

    dataset = common.build_dataset(reg, reg.select("split"))
    mano_path = reg.select("mano").get("mano_path") or None
    mano_stack = stack_mano_models(
        M.get_mano_model(mano_path, "right"), M.get_mano_model(mano_path, "left"), device
    )

    out_dir = reg.select("out")
    written = []
    for idx in reg.select("indices"):
        s = dataset[int(idx)]
        hs = torch.tensor([0 if s["hand_side"] == "rh" else 1], device=device)
        with torch.no_grad():
            _, joints, _ = batch_recover_mano(
                mano_stack, torch.as_tensor(np.asarray(s["pose_repr"]), device=device)[None],
                torch.as_tensor(np.asarray(s["shape"]), device=device)[None], hs,
            )
        n = int(s["len"])
        joints = joints[0, :n].cpu().numpy()
        merged = transf_merge_obj_pointcloud(s["obj_pointcloud"], np.asarray(s["obj_traj"])[:, :n]).numpy()
        png = os.path.join(out_dir, f"seg_{idx:04d}.png")
        render_sequence_grid(joints, obj_points_seq=merged, out_path=png)
        written.append(png)
        if reg.select("gif"):
            save_sequence_gif(joints, os.path.join(out_dir, f"seg_{idx:04d}.gif"), obj_points_seq=merged)
        if reg.select("html"):
            export_html_viewer(
                os.path.join(out_dir, f"seg_{idx:04d}.html"),
                [
                    {"name": "GT hand", "pos": joints, "kind": "skeleton", "color": "#2ca02c"},
                    {"name": "object", "pos": merged, "kind": "cloud", "color": "#ff7f0e", "alpha": 0.5},
                ],
                title=f"segment {idx} ({reg.select('split')})",
            )
        print(f"rendered segment {idx} -> {out_dir}")
    return written


if __name__ == "__main__":
    main()

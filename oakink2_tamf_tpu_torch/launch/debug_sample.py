"""Debug/visual check of G: sample a few segments with the DDPM chain and
render GT against sample (port of scripts/debug_sample.py; the reference's
script/debug/debug_train_sample.py, headless).

    python -m oakink2_tamf_tpu_torch.launch.debug_sample --cfg config/synthetic_smoke.yml \
        [--model_filepath G.pt] [--n_samples 2] [--html true] [--runtime.device cpu] \
        --out tmp/debug_sample

Writes sample_<i>.png (sample joints over the GT's, with the moved object
clouds) and, with --html, sample_<i>.html, for the first `n_samples`
segments of the test split. The chain is core/diffusion.p_sample_loop
(clip_denoised off) on a generator seeded 0 on the run's device. Without
--model_filepath G is randomly initialised from seed 0; a .pt is a
reference state_dict (run under "gelu_exact") or a port train checkpoint,
a .ckpt the JAX package's (launch/common.activation_for_checkpoint). As in the JAX script the batch
is collated at 2 object slots of 512 points whatever data.* says, and
--refine_filepath is registered but unused.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..core import diffusion as D
from ..core import mano as M
from ..data.collate import SegmentCollate
from ..eval.metrics import transf_merge_obj_pointcloud
from ..models.refine_r import batch_recover_mano, stack_mano_models
from ..parallel import train as PT
from ..runtime.ckpt import load_model_weights
from ..runtime.config import ConfigRegistry
from ..viz.html_viewer import export_html_viewer
from ..viz.render import render_sequence_grid
from . import common, param
from .train_g import build_model


def main(argv=None) -> torch.Tensor:
    """-> the sampled pose_repr [n, L, 99] (on the CPU)."""
    reg = ConfigRegistry("debug_sample")
    param.reg_base_param(reg)
    param.reg_mano_param(reg)
    param.reg_model_param(reg)
    param.reg_diffusion_param(reg)
    reg.register("model_filepath", category=str, default="")
    reg.register("refine_filepath", category=str, default="")
    reg.register("out", category=str, default="tmp/debug_sample")
    reg.register("n_samples", category=int, default=2)
    reg.register("html", category=bool, default=False,
                 desc="also export an interactive sample_<i>.html viewer")
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, argv)
    device = common.run_device(reg)

    dataset = common.build_dataset(reg, "test")
    clip = common.build_clip(reg, device)
    fp = reg.select("model_filepath")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(reg, activation=common.activation_for_checkpoint(reg, fp))
    if fp:
        load_model_weights(model, fp)
    model.to(device).eval().requires_grad_(False)
    dcfg = reg.select("diffusion")
    sched = D.tamf_schedule(int(dcfg.get("steps", 1000)), str(dcfg.get("noise_schedule", "cosine"))).to(device)
    mano_path = reg.select("mano").get("mano_path") or None
    mano_stack = stack_mano_models(
        M.get_mano_model(mano_path, "right"), M.get_mano_model(mano_path, "left"), device
    )

    n = min(int(reg.select("n_samples")), len(dataset))
    collate = SegmentCollate(max_nobj=2, n_obj_points=512)
    batch = collate([dataset[i] for i in range(n)])
    db = common.device_batch(common.attach_text_emb(batch, clip), device)
    L = db["pose_repr"].shape[1]
    with torch.inference_mode():
        pred = D.p_sample_loop(
            PT.g_model_fn(model, PT.g_cond_from_batch(db)), sched, (n, L, 99), device=device,
            generator=torch.Generator(device=device).manual_seed(0), clip_denoised=False,
        )
        _, j_gt, _ = batch_recover_mano(mano_stack, db["pose_repr"], db["shape"], db["hand_side"])
        _, j_pred, _ = batch_recover_mano(mano_stack, pred, db["shape"], db["hand_side"])
    j_gt, j_pred = j_gt.cpu().numpy(), j_pred.cpu().numpy()

    out_dir = reg.select("out")
    for i in range(n):
        merged = transf_merge_obj_pointcloud(batch["obj_points"][i], batch["obj_traj"][i]).numpy()
        render_sequence_grid(
            j_pred[i], obj_points_seq=merged, joints_ref_seq=j_gt[i],
            out_path=os.path.join(out_dir, f"sample_{i:03d}.png"),
        )
        if reg.select("html"):
            export_html_viewer(
                os.path.join(out_dir, f"sample_{i:03d}.html"),
                [
                    {"name": "GT hand", "pos": j_gt[i], "kind": "skeleton", "color": "#999999", "alpha": 0.7},
                    {"name": "G sample", "pos": j_pred[i], "kind": "skeleton", "color": "#1f77b4"},
                    {"name": "object", "pos": merged, "kind": "cloud", "color": "#ff7f0e", "alpha": 0.5},
                ],
                title=f"G sample {i}",
            )
        print(f"wrote {out_dir}/sample_{i:03d}.png")
    return pred.cpu()


if __name__ == "__main__":
    main()

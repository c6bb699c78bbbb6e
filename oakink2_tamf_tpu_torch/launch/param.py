"""Config-entry registration shared by the launch CLIs (copy of
oakink2_tamf_tpu/launch/param.py, plus `runtime.device`,
`runtime.dist_backend`, the `fused_cull` choice of `train.dist_impl` and
train_g's `runtime.profile_dir`; mirrors
reference launch/param/{base,mano,model,loss,loss_refine}.py — the schema,
not the code). The same YAMLs drive both packages; entries about the TPU
are accepted and documented where the port reads them."""

from __future__ import annotations

from ..runtime.config import ConfigRegistry


def reg_base_param(reg: ConfigRegistry) -> None:
    reg.register("exp_id", category=str, default="?(prog)__?(ts)")
    reg.register("seed", prefix="runtime", category=int, default=0)
    reg.register("num_worker", prefix="runtime", category=int, default=2)
    reg.register("device_count", prefix="runtime", category=int, default=0,
                 desc="0 = any; else must equal the process group's world size")
    reg.register("device", prefix="runtime", category=str, default="cuda",
                 desc="torch device of the run: cuda (default: the card of LOCAL_RANK; raises without a "
                      "GPU), cuda:N, or cpu")
    reg.register("dist_backend", prefix="runtime", category=str, default="",
                 desc="torch.distributed backend under torchrun: nccl on CUDA, gloo on the CPU by default")

    reg.register("data_prefix", prefix="data", category=str, default="")
    reg.register("obj_embedding_prefix", prefix="data", category=str, default="")
    reg.register("obj_pointcloud_prefix", prefix="data", category=str, default="")
    reg.register("enable_obj_model", prefix="data", category=bool, default=False)
    reg.register("append_reverse_segment", prefix="data", category=bool, default=False)
    reg.register("max_nobj", prefix="data", category=int, default=4)
    reg.register("n_obj_points", prefix="data", category=int, default=2048)
    reg.register("synthetic", prefix="data", category=bool, default=False,
                 desc="use the synthetic dataset (no OakInk2 assets required)")
    reg.register("synthetic_size", prefix="data", category=int, default=64)
    reg.register("synthetic_seq_len", prefix="data", category=int, default=160)

    for split in ("train", "val", "test"):
        # colon-separated (reference COLON_SEP for path lists — paths may
        # contain commas; numeric lists stay comma-separated)
        reg.register("process_range", prefix=split, category=str, is_list=True,
                     default=[], sep=":")
        reg.register("cache_dict_filepath", prefix=split, category=str, default="")
        reg.register("batch_size", prefix=split, category=int, default=64 if split == "train" else 8)


def reg_profile_param(reg: ConfigRegistry) -> None:
    reg.register("profile_dir", prefix="runtime", category=str, default="",
                 desc="write a device trace of train steps 11-20 here (or set TAMF_PROFILE_DIR)")


def reg_mano_param(reg: ConfigRegistry) -> None:
    reg.register("mano_path", prefix="mano", category=str, default="",
                 desc="MANO assets root (synthetic stand-in when empty)")


def reg_model_param(reg: ConfigRegistry) -> None:
    reg.register("input_dim", prefix="model", category=int, default=99)
    reg.register("obj_input_dim", prefix="model", category=int, default=9)
    reg.register("hand_shape_dim", prefix="model", category=int, default=10)
    reg.register("obj_embed_dim", prefix="model", category=int, default=768)
    reg.register("latent_dim", prefix="model", category=int, default=256)
    reg.register("ff_size", prefix="model", category=int, default=1024)
    reg.register("num_layers", prefix="model", category=int, default=8)
    reg.register("num_heads", prefix="model", category=int, default=4)
    reg.register("dropout", prefix="model", category=float, default=0.1)
    reg.register("activation", prefix="model", category=str, default="gelu")
    reg.register("cond_mask_prob", prefix="model", category=float, default=0.0)
    reg.register("remat", prefix="model", category=bool, default=False,
                 desc="rematerialize trunk layers (memory for FLOPs)")
    reg.register("compute_dtype", prefix="model", category=str, default="float32",
                 choices=["float32", "bfloat16"],
                 desc="trunk compute dtype; bfloat16 = the trunk's matmuls on the tensor cores")


def reg_train_param(reg: ConfigRegistry, default_epochs: int = 400) -> None:
    reg.register("num_epoch", prefix="train", category=int, default=default_epochs)
    reg.register("lr", prefix="train", category=float, default=1e-4)
    reg.register("weight_decay", prefix="train", category=float, default=0.0)
    reg.register("grad_clip", prefix="train", category=float, default=0.1)
    reg.register("scheduler_milestone", prefix="train", category=int, is_list=True, default=[150, 250])
    reg.register("scheduler_gamma", prefix="train", category=float, default=0.5)
    reg.register("record_freq", prefix="train", category=int, default=20)
    reg.register("reload_ckpt_model_filepath", prefix="train", category=str, default="")
    reg.register("val_freq", prefix="train", category=int, default=50)
    reg.register("schedule_sampler", prefix="train", category=str, default="uniform",
                 choices=["uniform", "loss-second-moment"])
    reg.register("chunk", prefix="train", category=int, default=2048,
                 desc="object points per tile of the fused_cull route's region-cull mask and of "
                      "the xla h2o route's search")
    reg.register("dist_impl", prefix="train", category=str, default="auto",
                 choices=["auto", "fused", "composed", "fused_cull"],
                 desc="G dist_h/dist_o route: fused (= auto) = single-pass loss kernel "
                      "(ops/chamfer_loss), fused_cull = the same with the region-cull "
                      "mask and the culled kernel, composed = point2point_signed + "
                      "PyTorch loss math")
    reg.register("h2o_backend", prefix="train", category=str, default="auto",
                 choices=["auto", "cull", "exact", "pallas", "cluster", "xla"],
                 desc="h2o NN route: auto = exact kernels (the bounds-culled "
                      "exact kernel at 4096+ object points, the all-pairs one "
                      "below); cull forces the culled one, exact/pallas the "
                      "all-pairs one; cluster = the pruned kernel OPT-IN "
                      "(monitored by the val-epoch exactness certificate — "
                      "only sound when its candidate budget covers the "
                      "cloud's cells); xla = the streaming scan in plain "
                      "matmuls, train.chunk points per tile, no kernel")
    reg.register("eval_max_batches", prefix="train", category=int, default=0,
                 desc="val/test batches per eval pass; 0 = the FULL split "
                      "(reference parity, launch/train.py:577-656)")
    reg.register("cache_gt_geom", prefix="train.data", category=bool, default=False,
                 desc="precompute G's GT-side signed chamfer per segment "
                      "(gt_o2h/gt_h2o) instead of recomputing it every step")
    reg.register("gt_geom_cache_dir", prefix="train.data", category=str, default="",
                 desc="disk dir for the GT-geometry cache (~10.5 MB/segment "
                      "f32 at production shapes); empty = in-memory")


def reg_diffusion_param(reg: ConfigRegistry) -> None:
    reg.register("steps", prefix="diffusion", category=int, default=1000)
    reg.register("noise_schedule", prefix="diffusion", category=str, default="cosine")
    reg.register("timestep_respacing", prefix="diffusion", category=str, default="")


def reg_loss_param(reg: ConfigRegistry) -> None:
    reg.register("vpe_path", prefix="train.loss", category=str, default="")
    reg.register("c_weight_path", prefix="train.loss", category=str, default="")
    reg.register("coef_rec_joint_loss", prefix="train.loss", category=float, default=1.0)
    reg.register("coef_rec_vert_loss", prefix="train.loss", category=float, default=1.0)
    reg.register("coef_edge_len_loss", prefix="train.loss", category=float, default=0.1)
    reg.register("coef_dist_h_loss", prefix="train.loss", category=float, default=0.1)
    reg.register("coef_dist_o_loss", prefix="train.loss", category=float, default=1.0)


def reg_clip_param(reg: ConfigRegistry) -> None:
    reg.register("checkpoint_path", prefix="clip", category=str, default="")
    reg.register("bpe_path", prefix="clip", category=str, default="")


def reg_sample_param(reg: ConfigRegistry) -> None:
    reg.register("model_filepath", prefix="sample", category=str, default="")
    reg.register("split", prefix="sample", category=str, default="test")
    reg.register("batch_size", prefix="sample", category=int, default=32)
    reg.register("sampler", prefix="sample", category=str, default="ddpm",
                 choices=["ddpm", "ddim", "plms", "parallel"],
                 desc="'parallel' = Picard-window DDPM (latency-oriented; "
                      "same chain in distribution, see sample.parallel_*)")
    reg.register("parallel_window", prefix="sample", category=int, default=64,
                 desc="Picard window W for sampler=parallel (one batched "
                      "model call evaluates W steps per sweep)")
    reg.register("parallel_tol", prefix="sample", category=float, default=0.01,
                 desc="slide tolerance tau for sampler=parallel: positions "
                      "advance once drift^2 <= tau^2 * posterior_variance[t]; "
                      "0 = bit-equivalent to the sequential pinned-noise chain")
    reg.register("save_prefix", prefix="sample", category=str, default="")
    reg.register("num_shards", prefix="sample", category=int, default=0,
                 desc="0 = the torch.distributed world size when a process group is "
                      "initialised, else one shard; explicit for external launchers")
    reg.register("shard_index", prefix="sample", category=int, default=-1,
                 desc="-1 = the torch.distributed rank when initialised, else 0")


def reg_refine_sample_param(reg: ConfigRegistry) -> None:
    for split in ("train", "val", "test"):
        # colon-separated path list (reference sample_refine COLON_SEP)
        reg.register("pose_repr_sample_dir_list", prefix=f"{split}.data", category=str,
                     is_list=True, default=[], sep=":")
    reg.register("gaussian_perturb_range", prefix="train.data", category=float,
                 is_list=True, default=[0.02, 0.1])
    reg.register("cache_target_h2o", prefix="train.data", category=bool, default=True,
                 desc="precompute GT h2o once (drops the per-step target chamfer)")
    reg.register("target_h2o_cache_dir", prefix="train.data", category=str, default="",
                 desc="on-disk target_h2o cache (empty = in-memory)")

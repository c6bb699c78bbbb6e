"""Precompute the interaction-segment cache_dict pickle (port of
scripts/save_cache_dict.py; the reference's script/save_cache_dict.py
workflow).

    python -m oakink2_tamf_tpu_torch.launch.save_cache_dict --cfg config/split.yml \
        --data.data_prefix /path/to/OakInk2 --out common/cache/train.pkl \
        --split train [--runtime.device cpu] --commit

With --data.synthetic true it writes a cache built from the synthetic
segments (the JAX script's pickle: infos, lengths, shapes, hand sides,
texts and frame ids; empty pose, tsl, obj_traj and object lists). The real
path needs the OakInk2 toolkit (`oakink2_toolkit`) and raises SystemExit
without it; it collects the split's process ranges through
data/segment.InteractionSegmentData and writes its cache. Nothing is
written without --commit. Like every launcher it checks runtime.device
(raises without a GPU unless told "cpu"), though nothing here runs on it.
"""

from __future__ import annotations

import argparse
import os
import pickle

from ..data.segment import InteractionSegmentData
from ..runtime.config import ConfigRegistry
from . import common, param


def main(argv=None) -> int:
    """-> the number of segments collected."""
    reg = ConfigRegistry("save_cache_dict")
    param.reg_base_param(reg)
    reg.register("out", category=str, default="common/cache/cache_dict.pkl")
    reg.register("split", category=str, default="train", choices=["train", "val", "test", "all"])
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, argv)
    common.run_device(reg)

    split = reg.select("split")
    out = reg.select("out")
    commit = bool(reg.values.get("commit"))
    if reg.select("data").get("synthetic"):
        ds = common.build_dataset(reg, split if split != "all" else "train")
        if commit:
            items = [ds[i] for i in range(len(ds))]
            cache = {
                "interaction_segment_info_list": [s["info"] for s in items],
                "interaction_segment_len_list": [s["len"] for s in items],
                "interaction_segment_pose_list": [],
                "interaction_segment_tsl_list": [],
                "interaction_segment_shape_list": [s["shape"] for s in items],
                "interaction_segment_hand_side_list": [s["hand_side"] for s in items],
                "interaction_segment_text_list": [s["text"] for s in items],
                "interaction_segment_obj_traj_list": [],
                "interaction_segment_frame_id_list": [s["frame_id"] for s in items],
                "interaction_object_list": [],
            }
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            with open(out, "wb") as f:
                pickle.dump(cache, f)
            print(f"wrote synthetic cache ({len(ds)} segments) to {out}")
        return len(ds)

    try:
        from oakink2_toolkit.dataset import OakInk2__Dataset  # type: ignore
    except ImportError:
        raise SystemExit(
            "oakink2_toolkit is not installed in this environment; provide a "
            "cache_dict built elsewhere (the format is identical to the "
            "reference's) or run with --data.synthetic true"
        )
    toolkit = OakInk2__Dataset(dataset_prefix=reg.select("data")["data_prefix"], return_instantiated=True)
    ds = InteractionSegmentData(
        process_range_list=reg.select(split)["process_range"],
        data_prefix=reg.select("data")["data_prefix"],
        toolkit=toolkit,
    )
    if commit:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        ds.save_cache(out)
        print(f"wrote cache ({len(ds)} segments) to {out}")
    else:
        print(f"dry run: {len(ds)} segments collected (pass --commit to write)")
    return len(ds)


if __name__ == "__main__":
    main()

"""Sample adaptors (port of oakink2_tamf_tpu/data/adaptors.py:44-179;
reference dataset/pose_repr_sample.py).

Adaptors wrap a base dataset and attach `sample_pose_repr`, the input the
refiner R trains on:
- GeneratedPoseReprSampleAdaptor: G's cached samples, one .npy per segment;
- GaussianPerturbSampleAdaptor: GT plus scheduled Gaussian noise, rot6d
  re-normalized (in PyTorch, on the CPU);
- IdentitySampleAdaptor: GT passthrough.
They perturb or copy before collate, so padded frames stay zero (the
contract models/refine_r.sample_geometry relies on).
ActionRecognitionAdapter attaches the FID encoder's action label. `ACTION_LIST`
is the JAX package's list of OakInk2 primitive actions
(data/adaptors.py:22-41): 69 names, though its comment and the synthetic
label ids count 70.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch

from ..core import transforms as T

ACTION_LIST = [
    "cap", "scoop", "pour", "wipe", "spread", "grip", "scrape", "rearrange",
    "press_button", "place_onto", "take_outside", "hold", "cut", "screw",
    "assemble", "stir", "unscrew", "trigger_lever", "open_gate", "place_inside",
    "close_gate", "uncap", "brush_whiteboard", "close_laptop_lid", "use_keyboard",
    "remove_usb", "remove_power_plug", "plug_in_power_plug", "insert_usb",
    "use_gamecontroller", "insert_lightbulb", "pull_out_drawer", "insert_pencil",
    "sharpen_pencil", "remove_pencil", "write_on_paper", "remove_lid",
    "put_on_lid", "shear_paper", "staple_paper_together", "remove_the_pen_cap",
    "write_on_whiteboard", "cap_the_pen", "put_flower_into_vase",
    "push_in_drawer", "remove_lightbulb", "open_laptop_lid", "open_book",
    "use_mouse", "remove_from_test_tube_rack", "hold_test_tube",
    "heat_test_tube", "place_test_tube_on_rack_with_holder", "pour_in_lab",
    "place_on_test_tube_rack", "put_off_alcohol_lamp", "shake_lab_container",
    "place_asbestos_mesh", "uncap_alcohol_lamp", "ignite_alcohol_lamp",
    "heat_beaker", "stir_experiment_substances", "remove_test_tube", "swap",
    "remove_test_tube_from_rack_with_holder", "flip_open_tooth_paste_cap",
    "squeeze_tooth_paste", "flip_close_tooth_paste_cap", "close_book",
]
NUM_ACTIONS = len(ACTION_LIST)


class GeneratedPoseReprSampleAdaptor:
    """Pair each base sample with a cached G-sample .npy, in the order of the
    sorted file names (ref pose_repr_sample.py:18-52)."""

    def __init__(self, base, dir_list: Sequence[str]):
        self.base = base
        info_list, repr_map = [], {}
        for dir_path in dir_list:
            dir_base = os.path.basename(dir_path)
            for fname in sorted(f for f in os.listdir(dir_path) if os.path.splitext(f)[-1] == ".npy"):
                info = (dir_base, int(os.path.splitext(fname)[0]))
                info_list.append(info)
                repr_map[info] = np.load(os.path.join(dir_path, fname))
        if len(info_list) != len(base):
            raise ValueError(f"{len(info_list)} sample files for {len(base)} segments")
        self.info_list = info_list
        self.repr_map = repr_map

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self):
        return len(self.info_list)

    def __getitem__(self, index: int) -> dict[str, Any]:
        data = self.base[index]
        info = self.info_list[index]
        data["sample_info"] = info
        data["sample_pose_repr"] = self.repr_map[info].astype(np.float32)
        return data


class GaussianPerturbSampleAdaptor:
    """GT plus sigma-scheduled noise, translation noise 10x smaller, rot6d
    re-normalized (ref pose_repr_sample.py:55-94).

    Each __getitem__ draws from its own numpy Generator seeded with
    (seed, epoch, index): the loader fetches samples from a thread pool, so
    a shared stream would race, and the draws equal the JAX package's for
    the same (seed, epoch, index)."""

    def __init__(self, base, sigma_range=(0.02, 0.1), seed: int | None = None):
        self.base = base
        self.sigma_min, self.sigma_max = float(sigma_range[0]), float(sigma_range[1])
        self.seed = 0 if seed is None else int(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index: int) -> dict[str, Any]:
        data = self.base[index]
        n = int(data["len"])
        rng = np.random.default_rng((self.seed, self.epoch, int(index)))
        sigma = rng.uniform(self.sigma_min, self.sigma_max)
        sp = data["pose_repr"].copy()
        sp[:n, 0:3] += rng.normal(0, 0.1 * sigma, size=(n, 3))
        sp[:n, 3:99] += rng.normal(0, sigma, size=(n, 96))
        sp[:n] = T.renormalize_pose_repr_rot6d(torch.from_numpy(sp[:n])).numpy()
        data["sample_info"] = (index, sigma)
        data["sample_pose_repr"] = sp.astype(np.float32)
        return data


class IdentitySampleAdaptor:
    def __init__(self, base):
        self.base = base

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index: int) -> dict[str, Any]:
        data = self.base[index]
        data["sample_info"] = None
        data["sample_pose_repr"] = data["pose_repr"]
        return data


class ActionRecognitionAdapter:
    """Attach the action label parsed from the primitive identifier
    "<action>:<id>" in info[1]: its name, its index in ACTION_LIST and the
    one-hot over NUM_ACTIONS (ref action_adapter.py:28-40)."""

    def __init__(self, base):
        self.base = base

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index: int) -> dict[str, Any]:
        data = self.base[index]
        label = str(data["info"][1].split(":")[0])
        label_id = ACTION_LIST.index(label)
        onehot = np.zeros(NUM_ACTIONS, np.int32)
        onehot[label_id] = 1
        data["action_label"] = label
        data["action_label_id"] = np.int32(label_id)
        data["action_onehot"] = onehot
        return data


class ConcatDataset:
    """The datasets one after another, with set_epoch forwarded to each."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index: int):
        ds = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return self.datasets[ds][index - int(self.offsets[ds])]

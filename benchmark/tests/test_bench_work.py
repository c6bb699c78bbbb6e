"""The work counts equal a count of the reference's own matrix products
(torch's flop counter) and a hand count at small shapes."""

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import assets as A
from benchmark.lib import segments, work
from benchmark.reference import mano as RM
from benchmark.tests.tiny import tiny_spec


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _batch(cfg, n, seed=3):
    from benchmark.entries import common

    d = common.data_params(cfg, {"length_quantiles": [cfg["data"]["min_len"], cfg["data"]["seq_len"]],
                                 "obj_counts": list(range(1, int(cfg["data"]["max_nobj"]) + 1))})
    return segments.collate(segments.make_segments(seed, "work", n, d), int(cfg["data"]["max_nobj"]),
                            segments.text_table(seed, 7))


def test_trunk_counts_equal_the_flop_counter():
    from benchmark.entries import common

    for cell, key in (("g_mdm_l.train_fused", "g_model"), ("r_refine.train_cull", "r_model")):
        cfg = tiny_spec(cell)["cfg"]
        b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 3).items()}
        L, nobj = b["mask"].shape[1], int(cfg["data"]["max_nobj"])
        if key == "g_model":
            m = common.reference_g(cfg, 1, "cpu").eval()
            cond = {k: b[k] for k in ("text_emb", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask")}
            got = _counted(lambda: m(b["pose_repr"], torch.tensor([1, 5, 9]), cond))
            want = 3 * work.g_forward(cfg[key], L, nobj)
        else:
            m = common.reference_r(cfg, 1, "cpu").eval()
            cond = {k: b[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
            got = _counted(lambda: m(b["pose_repr"], torch.rand(3, L, 778), cond))
            want = 3 * work.r_forward(cfg[key], L, nobj)
        assert got == want, (cell, got, want)


def test_mano_count_equals_the_flop_counter():
    stack, _ = A.reference_mano("cpu")
    side = RM.side(stack, 0)
    q = torch.nn.functional.normalize(torch.randn(5, 16, 4), dim=-1)
    assert _counted(lambda: RM.mano_forward(side, q, torch.randn(5, 10))) == 5 * work.mano_frame()


def test_live_frames_and_search_by_hand():
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 0]], np.float32)
    obj_mask = np.array([[True, False, False], [True, True, False]])
    # sample 0: 2 frames x 1 object; sample 1: 3 frames x 2 objects
    assert work.live_frames(mask, obj_mask) == 2 + 6
    assert work.search(8, 100) == 8 * 8 * 778 * 100
    assert work.bound_s(67e12, 0) == 1.0 and work.bound_s(0, 3.35e12) == 1.0


def test_g_step_count_by_hand():
    from benchmark.entries import train_g

    spec = tiny_spec("g_mdm_l.train_fused")
    cfg = spec["cfg"]
    b = _batch(cfg, 4)
    bs, L = b["mask"].shape
    d, ff, layers, S = 32, 64, 2, L + 5
    enc = layers * (S * (6 * d * d + 2 * d * d + 4 * d * ff) + 4 * S * S * d)
    per_frame = 2 * 99 * d + 2 * 9 * d * 2 + 2 * 2 * d * d + 2 * d * d + 2 * d * 99
    cond = 2 * d * d * 2 + 2 * 512 * d + 2 * 10 * d + 2 * 768 * d
    fwd = L * per_frame + cond + enc
    live = int(((b["mask"] > 0)[:, None, :] & b["obj_mask"][:, :, None]).sum())
    want = 3 * bs * fwd + 4 * bs * L * work.mano_frame() + 2 * 8 * live * 778 * 256
    assert train_g.step_flops(cfg, b) == want

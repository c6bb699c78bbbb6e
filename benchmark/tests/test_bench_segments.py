"""The traffic generator: the same seed gives the same inputs, every seed the
same sizes, and the batched spatial sort is the program's sort."""

import numpy as np

from benchmark.lib import segments

P = {"seq_len": 32, "max_nobj": 4, "n_obj_points": 512, "min_len": 4, "n_prompts": 7,
     "length_quantiles": [4, 32], "obj_counts": [1, 2, 3, 4]}


def test_same_seed_same_inputs_large_seed():
    a = segments.make_segments(2**31 + 99, "pool", 12, P)
    b = segments.make_segments(2**31 + 99, "pool", 12, P)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k


def test_every_seed_and_group_gets_the_same_sizes_in_another_order():
    a = segments.make_segments(1, "pool", 48, P, group=16)
    b = segments.make_segments(2**31 + 5, "pool", 48, P, group=16)
    groups = [x[i : i + 16] for x in (a, b) for i in (0, 16, 32)]
    sizes = [sorted((s["len"], s["obj_num"], s["hand_side"]) for s in g) for g in groups]
    assert all(sz == sizes[0] for sz in sizes)
    assert len({tuple(s["len"] for s in g) for g in groups}) == len(groups)
    live = {int(((x["mask"] > 0)[:, None] & x["obj_mask"][:, :, None]).sum())
            for x in (segments.collate(g, 4) for g in groups)}
    assert len(live) == 1


def test_batched_sort_is_the_recursive_sort():
    rng = np.random.default_rng(0)
    for n_points in (256, 512, 1000):
        c = rng.normal(size=(5, n_points, 3)).astype(np.float32)
        want = np.stack([segments.spatial_sort_indices(x) for x in c])
        assert np.array_equal(segments.spatial_sort_many(c), want)

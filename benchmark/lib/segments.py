"""The traffic generator: synthetic interaction segments from the seed (after
oakink2_tamf_tpu_torch/data/synthetic.py `synthetic_batch` and
`with_perturbed_sample`, made per segment in the program's sample-dict
contract, with the clouds spatially sorted as utils/pc_util.py
`spatial_sort_indices` sorts them at collate time), and their collate.

The sizes come from the traffic mix's file: the true lengths of a group (a
batch or a call) are spread over `length_quantiles` (frames, interpolated
between the listed quantiles) and the object counts cycle over
`obj_counts`. Every seed gets the same set of sizes in another order, so
every pool has the same number of live frames whatever the seed. Poses,
shapes, trajectories, embeddings and clouds are drawn from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.transforms import renormalize_pose_repr_rot6d
from . import seeds


def spatial_sort_indices(points: np.ndarray, leaf: int = 128) -> np.ndarray:
    """Permutation making contiguous `leaf`-sized blocks spatially compact
    (balanced recursive median split along the widest axis)."""
    out: list[np.ndarray] = []

    def rec(ids: np.ndarray) -> None:
        if len(ids) <= leaf:
            out.append(ids)
            return
        p = points[ids]
        ax = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        half = max(leaf, (len(ids) // 2 // leaf) * leaf)
        part = np.argpartition(p[:, ax], half)
        rec(ids[part[:half]])
        rec(ids[part[half:]])

    rec(np.arange(points.shape[0]))
    return np.concatenate(out)


def spatial_sort_many(points: np.ndarray, leaf: int = 128) -> np.ndarray:
    """spatial_sort_indices of each cloud of points [n, P, 3], level by level
    over all clouds at once; the same permutations where P is leaf times a
    power of two (every split then halves its block), else cloud by cloud."""
    n, P, _ = points.shape
    if P <= leaf or P % leaf or (P // leaf) & (P // leaf - 1):
        return np.stack([spatial_sort_indices(p, leaf) for p in points])
    xyz = torch.from_numpy(np.ascontiguousarray(points.transpose(0, 2, 1)))[:, :, None, :]  # [n, 3, b, m]
    blocks = torch.arange(P).expand(n, 1, P)
    while blocks.shape[-1] > leaf:
        b, m = blocks.shape[1:]
        ax = torch.argmax(xyz.amax(dim=-1) - xyz.amin(dim=-1), dim=1)  # [n, b]
        vals = torch.gather(xyz, 1, ax[:, None, :, None].expand(n, 1, b, m))[:, 0]  # [n, b, m]
        part = torch.from_numpy(np.argpartition(vals.numpy(), m // 2, axis=-1))
        blocks = torch.gather(blocks, -1, part).reshape(n, 2 * b, m // 2)
        xyz = torch.gather(xyz, -1, part[:, None].expand(n, 3, b, m)).reshape(n, 3, 2 * b, m // 2)
    return blocks.reshape(n, P).numpy()


def _random_rot6d(rng, shape):
    """Rotations uniform on SO(3) (normalized Gaussian quaternions) as the
    first two rows of the matrix, flattened."""
    q = rng.normal(size=shape + (4,))
    w, x, y, z = np.moveaxis(q / np.linalg.norm(q, axis=-1, keepdims=True), -1, 0)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]
    return np.stack(rows, axis=-1).astype(np.float32)


def make_segments(seed: int, tag: str, n: int, p: dict, group: int | None = None) -> list[dict]:
    """`n` segments in the program's per-sample contract, in groups of `group`
    (a batch or a call; all `n` by default) that each hold the same sizes:
    the group's quantiles of `length_quantiles`, the i-th shortest with
    obj_counts[i % len(obj_counts)] objects, one hand side or the other in
    turn, the prompts in turn, each group in its own order. `p`: seq_len,
    max_nobj, n_obj_points, min_len, n_prompts, length_quantiles,
    obj_counts."""
    rng = seeds.rng(seed, tag)
    L, nobj, P = int(p["seq_len"]), int(p["max_nobj"]), int(p["n_obj_points"])
    group = group or n
    if n % group:
        raise ValueError(f"{n} segments do not fill groups of {group}")
    q = np.asarray(p["length_quantiles"], np.float64)
    counts = np.asarray(p["obj_counts"], np.int64)
    lens = np.round(np.interp(np.linspace(0, 1, group), np.linspace(0, 1, len(q)), q)).astype(np.int64)
    if lens.min() < int(p["min_len"]) or lens.max() > L or counts.min() < 1 or counts.max() > nobj:
        raise ValueError(f"lengths {q.tolist()} or object counts {counts.tolist()} outside "
                         f"[{p['min_len']}, {L}] and [1, {nobj}]")
    sizes = np.stack([lens, counts[np.arange(group) % len(counts)], np.arange(group) % 2,
                      np.arange(group) % int(p["n_prompts"])], axis=1)
    lens, n_real, sides, prompts = np.concatenate([sizes[rng.permutation(group)] for _ in range(n // group)]).T
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    tsl = rng.normal(scale=0.2, size=(n, L, 3)).astype(np.float32)
    pose = np.concatenate([tsl, _random_rot6d(rng, (n, L, 16)).reshape(n, L, 96)], axis=-1) * mask[:, :, None]
    shape = rng.normal(scale=0.5, size=(n, L, 10)).astype(np.float32) * mask[:, :, None]
    obj_tsl = rng.normal(scale=0.3, size=(n, nobj, L, 3)).astype(np.float32)
    obj_traj = np.concatenate([obj_tsl, _random_rot6d(rng, (n, nobj, L))], axis=-1) * mask[:, None, :, None]
    obj_emb = rng.normal(size=(n, nobj, 768)).astype(np.float32)
    clouds = rng.normal(scale=0.1, size=(int(n_real.sum()), P, 3)).astype(np.float32)
    clouds = clouds[np.arange(len(clouds))[:, None], spatial_sort_many(clouds)]
    first = np.concatenate([[0], np.cumsum(n_real)])
    out = []
    for i in range(n):
        k = int(n_real[i])
        out.append({
            "pose_repr": pose[i], "mask": mask[i], "len": int(lens[i]), "shape": shape[i],
            "hand_side": "rh" if sides[i] == 0 else "lh", "text": f"synthetic task {int(prompts[i])}",
            "obj_num": k, "obj_traj": obj_traj[i, :k], "obj_embedding": obj_emb[i, :k],
            "obj_pointcloud": clouds[first[i] : first[i + 1]],
        })
    return out


def text_table(seed: int, n_prompts: int, dim: int = 512) -> np.ndarray:
    """The text features of each prompt id [n_prompts, dim]: the inputs that
    stand in for CLIP's cached features."""
    return seeds.rng(seed, "text").normal(size=(n_prompts, dim)).astype(np.float32)


def prompt_id(text: str) -> int:
    return int(text.rsplit(" ", 1)[1])


def collate(samples: list[dict], max_nobj: int, text: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """Stack segments to a static-shape batch, the same for the program and the
    reference: objects padded to `max_nobj` with zeros and a bool obj_mask,
    hand side 0 = rh / 1 = lh, `text_emb` from the table when one is given
    (the clouds are already spatially sorted, as the program's collate
    sorts them)."""
    def pad(a):
        a = np.asarray(a, np.float32)
        return np.concatenate([a, np.zeros((max_nobj - a.shape[0],) + a.shape[1:], np.float32)], axis=0)

    b = {
        "pose_repr": np.stack([s["pose_repr"] for s in samples]),
        "mask": np.stack([s["mask"] for s in samples]).astype(np.float32),
        "shape": np.stack([s["shape"] for s in samples]),
        "hand_side": np.asarray([0 if s["hand_side"] == "rh" else 1 for s in samples], np.int64),
        "obj_traj": np.stack([pad(s["obj_traj"]) for s in samples]),
        "obj_embedding": np.stack([pad(s["obj_embedding"]) for s in samples]),
        "obj_points": np.stack([pad(s["obj_pointcloud"]) for s in samples]),
        "obj_mask": np.arange(max_nobj)[None, :] < np.asarray([s["obj_num"] for s in samples])[:, None],
    }
    if text is not None:
        b["text_emb"] = text[[prompt_id(s["text"]) for s in samples]]
    for key in ("sample_pose_repr", "target_h2o"):
        if key in samples[0]:
            b[key] = np.stack([s[key] for s in samples])
    return b


class Collate:
    """`collate` as a callable with the program's collate attributes, for the
    program's per-sample caches."""

    def __init__(self, max_nobj: int, n_obj_points: int, text: np.ndarray | None = None):
        self.max_nobj, self.n_obj_points, self.text = max_nobj, n_obj_points, text

    def __call__(self, samples: list[dict]) -> dict[str, np.ndarray]:
        return collate(samples, self.max_nobj, self.text)


def perturb(samples: list[dict], seed: int, tag: str, sigma_range) -> list[dict]:
    """Each segment with `sample_pose_repr`: one sigma per batch, translation
    noise at 0.1 sigma, rot6d noise at sigma, the rot6d blocks renormalized,
    zero past the true length."""
    rng = seeds.rng(seed, tag)
    sigma = rng.uniform(*sigma_range)
    out = []
    for s in samples:
        pr = np.asarray(s["pose_repr"])
        noisy = pr.copy()
        noisy[..., 0:3] += rng.normal(scale=0.1 * sigma, size=pr[..., 0:3].shape)
        noisy[..., 3:] += rng.normal(scale=sigma, size=pr[..., 3:].shape)
        sp = renormalize_pose_repr_rot6d(torch.from_numpy(noisy.astype(np.float32))).numpy()
        out.append(dict(s, sample_pose_repr=(sp * (s["mask"] > 0)[:, None]).astype(np.float32)))
    return out


def to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

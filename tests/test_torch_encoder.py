"""The FID encoder of the port against the JAX package: models/encoder
(weights through interop/from_jax), models/losses.segment_encoder_loss,
parallel/train.make_encoder_train_step, data/adaptors.ActionRecognitionAdapter
and launch/train_encoder.

Tolerances, float32 on both sides, dropout 0 (the two frameworks draw
different masks): the encoder forward atol 1e-5; the loss and accuracy
rtol 1e-6; two train steps loss rtol 1e-4, parameters atol 2e-3, and each
parameter's change over the two steps within 1e-2 of JAX's largest change
in that parameter (AdamW's first steps move each weight by about lr = 1e-4,
so only the change can tell a right step from a skipped or reversed one).
The classification token is a buffer: not in parameters(), zero after the
steps. ActionRecognitionAdapter is compared on the synthetic segments
except index 69, where the JAX package raises (its ACTION_LIST holds 69
names; the port maps id 69 to the first name, ROADMAP §C).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from oakink2_tamf_tpu.data.adaptors import ActionRecognitionAdapter as JActionRecognitionAdapter
from oakink2_tamf_tpu.launch.common import SyntheticSegments as JSyntheticSegments
from oakink2_tamf_tpu.models import losses as JLL
from oakink2_tamf_tpu.models.encoder import EncoderConfig as JEncoderConfig
from oakink2_tamf_tpu.models.encoder import SegmentEncoder as JSegmentEncoder
from oakink2_tamf_tpu.parallel import train as JPT
from oakink2_tamf_tpu_torch.data import fabricate as F
from oakink2_tamf_tpu_torch.data.adaptors import ActionRecognitionAdapter, NUM_ACTIONS
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments, synthetic_batch
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.launch import train_encoder
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models.encoder import COND_KEYS, EncoderConfig, SegmentEncoder
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime.ckpt import load_model_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config/synthetic_smoke.yml")
SMALL = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, dropout=0.0)


def _batch(seed: int = 0, bs: int = 4, L: int = 20):
    b = synthetic_batch(np.random.default_rng(seed), batch_size=bs, seq_len=L, max_nobj=3, n_obj_points=16)
    b["sample_pose_repr"] = (b["pose_repr"] + np.random.default_rng(seed + 1).normal(
        scale=0.05, size=b["pose_repr"].shape)).astype(np.float32)
    b["action_label_id"] = b["action_label_id"] % NUM_ACTIONS
    return b


def _models(activation: str = "gelu", seed: int = 0):
    """(JAX model, its variables, the port's model with the same weights)."""
    b = _batch()
    jm = JSegmentEncoder(JEncoderConfig(activation=activation, **SMALL))
    cond = {k: jnp.asarray(b[k]) for k in COND_KEYS}
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(b["pose_repr"]), cond)
    pm = SegmentEncoder(EncoderConfig(activation=activation, **SMALL))
    pm.load_state_dict(from_jax.encoder_state_dict_from_flax(jax.tree.map(np.asarray, variables)))
    return jm, variables, pm.eval()


def _torch_cond(b):
    return {k: torch.from_numpy(np.asarray(b[k])) for k in COND_KEYS}


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_encoder_forward_matches_flax(activation):
    jm, variables, pm = _models(activation)
    b = _batch(seed=3)
    want = jm.apply(variables, jnp.asarray(b["pose_repr"]), {k: jnp.asarray(b[k]) for k in COND_KEYS})
    with torch.no_grad():
        got = pm(torch.from_numpy(b["pose_repr"]), _torch_cond(b))
    for k in ("encoding", "activation"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)


def test_encoder_token_is_a_zero_buffer_in_the_reference_layout():
    pm = SegmentEncoder(EncoderConfig(**SMALL))
    names = dict(pm.named_parameters())
    assert "classification_token" not in names
    sd = pm.state_dict()
    assert torch.equal(sd["classification_token"], torch.zeros(1, 1, 32))
    assert {"output_process.poseFinal.0.weight", "output_process.poseFinal.2.weight",
            "output_process.poseFinal.4.weight", "input_merge.0.weight", "input_merge.2.weight",
            "seqTransEncoder.layers.1.self_attn.in_proj_weight"} <= set(sd)
    assert not any(k.endswith(".pe") for k in sd)  # the PE table is rebuilt, not stored


def test_segment_encoder_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(9, NUM_ACTIONS)).astype(np.float32)
    label = rng.integers(0, NUM_ACTIONS, size=9).astype(np.int32)
    label[:3] = np.argmax(logits[:3], axis=-1)  # some right answers
    got, got_terms = LL.segment_encoder_loss({"activation": torch.from_numpy(logits)}, torch.from_numpy(label))
    want, want_terms = JLL.segment_encoder_loss({"activation": jnp.asarray(logits)}, jnp.asarray(label))
    assert sorted(got_terms) == sorted(want_terms) == ["acc", "ce", "loss"]
    for k in want_terms:
        np.testing.assert_allclose(float(got_terms[k]), float(want_terms[k]), rtol=1e-6, err_msg=k)
    assert float(got_terms["acc"]) >= 3 / 9


def test_encoder_train_steps_match_jax():
    """Two steps (the second after a MultiStepLR milestone), on
    sample_pose_repr, from the same weights and batches."""
    jm, variables, pm = _models()
    jopt = JPT.make_optimizer(base_lr=1e-4, grad_clip=0.1, milestones_steps=[1], gamma=0.5)
    jstate = JPT.init_train_state(variables, jopt)
    jstep = JPT.make_encoder_train_step(jm, jopt)
    init = {k: v.clone() for k, v in pm.state_dict().items()}
    state = PT.TrainState(pm, PT.make_optimizer(pm.named_parameters(), base_lr=1e-4, grad_clip=0.1,
                                                milestones_steps=[1], gamma=0.5))
    step = PT.make_encoder_train_step()
    for i in range(2):
        b = _batch(seed=10 + i)
        jstate, jm_metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        metrics = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
        np.testing.assert_allclose(float(metrics["loss"]), float(jm_metrics["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(metrics["acc"]), float(jm_metrics["acc"]), rtol=1e-6)
    assert state.step == 2 and state.optimizer.lr == pytest.approx(0.5e-4)
    want = from_jax.encoder_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = pm.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-3, rtol=0, err_msg=k)
        if k == "classification_token":
            continue
        want_d, got_d = (v - init[k]).double(), (got[k] - init[k]).double()
        if k.endswith("self_attn.in_proj_bias"):
            # the key bias adds q.b to every logit of a query's row, which the
            # softmax cancels: its gradient is rounding noise that Adam scales
            # to +-lr, so only the query and value biases are compared
            d = want_d.shape[0] // 3
            want_d, got_d = torch.cat([want_d[:d], want_d[2 * d :]]), torch.cat([got_d[:d], got_d[2 * d :]])
        scale = float(want_d.abs().max())
        assert scale > 0, f"{k}: JAX's steps left it unchanged"
        assert float((got_d - want_d).abs().max()) <= 1e-2 * scale, f"{k}: the change differs from JAX's"
    assert torch.equal(pm.classification_token, torch.zeros(1, 1, 32))
    assert np.all(np.asarray(jstate.params["buffers"]["classification_token"]) == 0)


def test_action_recognition_adapter_matches_jax():
    """Labels on the synthetic segments (index 69 left out: JAX raises
    there) and the port's map of id 69 to the first name."""
    port = ActionRecognitionAdapter(SyntheticSegments(72, seq_len=16, max_nobj=2, n_obj_points=32))
    jax_ds = JActionRecognitionAdapter(JSyntheticSegments(72, seq_len=16, max_nobj=2, n_obj_points=32))
    for i in [*range(0, 69, 7), 68, 70, 71]:
        got, want = port[i], jax_ds[i]
        assert got["action_label"] == want["action_label"]
        assert got["action_label_id"] == want["action_label_id"]
        assert got["action_label_id"].dtype == want["action_label_id"].dtype == np.int32
        np.testing.assert_array_equal(got["action_onehot"], want["action_onehot"])
    with pytest.raises(IndexError):
        jax_ds[69]
    assert port[69]["action_label_id"] == 0 and port[69]["action_onehot"].sum() == 1


def test_train_encoder_main_cpu_smoke(tmp_path, monkeypatch):
    """The launcher on the synthetic smoke config: two epochs with a val and
    test pass, a checkpoint that loads back into build_encoder."""
    monkeypatch.chdir(tmp_path)
    state = train_encoder.main(["--cfg", SMOKE, "--runtime.device", "cpu", "--exp_id", "enc",
                                "--train.val_freq", "1", "--train.eval_max_batches", "1",
                                "--runtime.num_worker", "0", "--commit"])
    assert state.step == 2 * 4  # (16 identity + 16 perturbed) / batch 8, two epochs
    assert torch.equal(state.model.classification_token, torch.zeros_like(state.model.classification_token))
    ckpt = tmp_path / "common/train_encoder/enc/save/model_0001.pt"
    assert ckpt.is_file()
    again = SegmentEncoder(EncoderConfig(**SMALL))
    load_model_weights(again, str(ckpt))
    for k, v in state.model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_train_encoder_main_on_a_fabricated_cache(tmp_path, monkeypatch):
    """The launcher on real-format data: a cache_dict pickle with its object
    stores, through build_dataset's real branch."""
    paths = F.write_dataset(str(tmp_path), 12, seq_len=160, n_obj=3, n_points=256, seed=1)
    monkeypatch.chdir(tmp_path)
    state = train_encoder.main([
        "--cfg", SMOKE, "--runtime.device", "cpu", "--exp_id", "enc_fab", "--runtime.num_worker", "0",
        "--data.synthetic", "false", "--data.max_nobj", "2", "--data.n_obj_points", "256",
        "--train.cache_dict_filepath", paths["cache_dict"], "--val.cache_dict_filepath", paths["cache_dict"],
        "--data.obj_embedding_prefix", paths["obj_embedding_prefix"],
        "--data.obj_pointcloud_prefix", paths["obj_pointcloud_prefix"],
        "--train.num_epoch", "1", "--train.val_freq", "1",
    ])
    assert state.step == 3  # (12 + 12) / 8
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_train_encoder_refuses_a_silent_cpu_run(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_encoder.main(["--cfg", SMOKE, "--exp_id", "enc_nogpu"])

"""``vimo-convert-torch`` (``vimoclip_tpu_torch/cli/convert.py``) on the CPU:
the port's stage-2 and stage-1 checkpoints exported to the reference's
``.pth`` formats, held against the JAX package's loaders, predictor and
``vimo-convert`` on the same weights."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu.cli import convert as jax_convert
from vimoclip_tpu.config import TFAMModelConfig as JTFAMConfig
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JVision
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JEncoder
from vimoclip_tpu.models.torch_compat import (
    student_params_from_checkpoint,
    student_params_from_torch,
    student_params_to_torch,
    tfam_params_from_checkpoint,
    tfam_params_from_torch,
    tfam_params_to_torch,
)
from vimoclip_tpu.serving import ViMoCLIPPredictor as JPredictor
from vimoclip_tpu.train.state import CheckpointManager as JCheckpointManager
from vimoclip_tpu.train.state import TrainState as JTrainState
from vimoclip_tpu.train.state import make_adam as jax_make_adam
from vimoclip_tpu_torch.cli import convert
from vimoclip_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    LoggingConfig,
    TFAMModelConfig,
    TrainingConfig,
)
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig
from vimoclip_tpu_torch.models.convert import (
    clip_vision_state_from_jax,
    student_visual_state_from_checkpoint,
    tfam_state_from_checkpoint,
)
from vimoclip_tpu_torch.models.student import StudentModel
from vimoclip_tpu_torch.models.tfam import TFAM
from vimoclip_tpu_torch.serving import ViMoCLIPPredictor
from vimoclip_tpu_torch.train.state import CheckpointManager, TrainState, make_adam
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

torch.set_num_threads(1)

D, C, LAYERS = 16, 5, 2
# one head: reference checkpoints carry no head count and the loaders infer
# max(1, hidden // 64)
VGEOM = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
             num_heads=1, intermediate_size=64, projection_dim=D)
TGEOM = dict(d_model=D, nhead=2, num_layers=LAYERS, dim_feedforward=32, dropout=0.0,
             mlp_dropout=0.0, attention_impl="xla")


def _items(n=8, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        t = int(rng.integers(5, 11))
        labels = np.zeros(C, np.float32)
        labels[i % C] = 1.0
        items.append({"video_id": f"v{i}.mp4",
                      "embeddings": rng.standard_normal((t, D)).astype(np.float32),
                      "motion_embeddings": rng.standard_normal((t - 1, D)).astype(np.float32),
                      "labels": labels})
    return items


@pytest.fixture(scope="module")
def tfam_ckpt(tmp_path_factory):
    """A port ``TFAMTrainer``'s checkpoint directory after one epoch."""
    d = tmp_path_factory.mktemp("tfam_ckpt")
    cfg = ExperimentConfig(
        training=TrainingConfig(epochs=1, batch_size=4, num_workers=1, lr=1e-3,
                                device="cpu", seed=49),
        logging=LoggingConfig(), data=DataConfig(num_classes=C, length_bucket=8),
        model=TFAMModelConfig(**TGEOM))
    items = _items()
    with pytest.MonkeyPatch.context() as mp:
        # no TensorBoard (as on the card's machine): its import takes seconds
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        TFAMTrainer(cfg, str(d / "logs"), str(d / "ck"), items, items).train()
    return str(d / "ck")


@pytest.fixture(scope="module")
def teacher():
    return JEncoder(JVision(**VGEOM)).init(jax.random.key(0),
                                           jnp.zeros((1, 32, 32, 3)))["params"]


@pytest.fixture(scope="module")
def student_ckpt(tmp_path_factory):
    """A stage-1 checkpoint in the port's layout (``CheckpointManager``, as
    ``StudentTrainer`` saves it), on seeded random weights."""
    d = tmp_path_factory.mktemp("student_ckpt")
    torch.manual_seed(3)
    model = StudentModel(ClipVisionConfig(**VGEOM), num_classes=C)
    with torch.no_grad():
        for p in model.residual_mlp.fc2.parameters():
            p.normal_(0.0, 0.02)  # off the zero init, so the copy is checked
    CheckpointManager(str(d / "ck")).save(
        TrainState(model, make_adam(model.parameters(), 1e-3)), "best",
        extra={"epoch": 2, "best_metric": -0.5})
    return str(d / "ck"), {k: v.numpy() for k, v in model.state_dict().items()}


def _strip(state, prefix):
    assert all(k.startswith("module.") for k in state) == prefix
    return {k.removeprefix("module."): v for k, v in state.items()}


@pytest.mark.parametrize("prefix", [False, True], ids=["bare", "module-prefix"])
def test_tfam_to_torch_loads_strictly_in_both_packages(tfam_ckpt, tmp_path, prefix):
    out = str(tmp_path / "best_model.pth")
    assert convert.main(["tfam-to-torch", "--checkpoint-dir", tfam_ckpt, "--out", out]
                        + (["--module-prefix"] if prefix else [])) == 0
    payload = torch.load(out, weights_only=True)
    assert sorted(payload) == ["best_val_mAP", "epoch", "state_dict"]
    assert payload["epoch"] == 0 and 0.0 <= payload["best_val_mAP"] <= 1.0
    state = _strip(payload["state_dict"], prefix)
    # the JAX package's loader reads every key, and its exporter with the
    # reference's unconditional modules gives the same set back, bit for bit
    params = tfam_params_from_checkpoint(out, num_layers=LAYERS, d_model=D)
    back = tfam_params_to_torch(params, num_layers=LAYERS, fill_missing_reference_modules=True)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    TFAM(TFAMModelConfig(**TGEOM), num_classes=C).load_state_dict(state, strict=True)


@pytest.mark.parametrize("prefix", [False, True], ids=["bare", "module-prefix"])
def test_tfam_to_torch_matches_jax_convert(tfam_ckpt, tmp_path, prefix):
    """The JAX ``convert_tfam`` of the same weights, saved as an Orbax
    checkpoint by the JAX trainer's manager, writes the same keys, shapes
    and values."""
    out = str(tmp_path / "port.pth")
    got = convert.convert_tfam(tfam_ckpt, out, module_prefix=prefix)
    state = {k: v.numpy() for k, v in _strip(got["state_dict"], prefix).items()}
    orbax = tmp_path / "orbax"
    mgr = JCheckpointManager(str(orbax))
    mgr.save(JTrainState.create(tfam_params_from_torch(state, num_layers=LAYERS, d_model=D),
                                jax_make_adam(1e-3)),
             "best", extra={"epoch": got["epoch"], "best_metric": got["best_val_mAP"]})
    mgr.wait_until_finished()
    ref = jax_convert.convert_tfam(str(orbax), str(tmp_path / "jax.pth"),
                                   module_prefix=prefix)
    assert ref.keys() == got.keys()
    assert ref["epoch"] == got["epoch"] and ref["best_val_mAP"] == got["best_val_mAP"]
    assert ref["state_dict"].keys() == got["state_dict"].keys()
    for k, v in got["state_dict"].items():
        assert ref["state_dict"][k].shape == v.shape, k
        np.testing.assert_array_equal(ref["state_dict"][k].numpy(), v.numpy(), err_msg=k)


def test_tfam_to_torch_num_layers(tfam_ckpt, tmp_path):
    out = str(tmp_path / "one.pth")
    state = convert.convert_tfam(tfam_ckpt, out, num_layers=1)["state_dict"]
    assert {k.split(".")[1] for k in state if k.startswith("layers.")} == {"0"}
    TFAM(TFAMModelConfig(**(TGEOM | {"num_layers": 1})), num_classes=C).load_state_dict(
        state, strict=True)
    with pytest.raises(SystemExit, match="has 2 layers"):
        convert.convert_tfam(tfam_ckpt, out, num_layers=3)


@pytest.mark.parametrize("prefix", [False, True], ids=["bare", "module-prefix"])
def test_student_to_torch_loads_in_both_packages(student_ckpt, tmp_path, prefix):
    ckpt, weights = student_ckpt
    out = str(tmp_path / "student_best.pth")
    assert convert.main(["student-to-torch", "--checkpoint-dir", ckpt, "--out", out]
                        + (["--module-prefix"] if prefix else [])) == 0
    state = _strip(torch.load(out, weights_only=True), prefix)
    assert set(state) == set(weights)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), weights[k], err_msg=k)
    StudentModel(ClipVisionConfig(**VGEOM), num_classes=C).load_state_dict(state,
                                                                          strict=True)
    # the JAX loader infers the tower from the shapes and reads every key:
    # its params carry the same weights back
    jcfg, params = student_params_from_checkpoint(out)
    assert (jcfg.hidden_size, jcfg.num_layers, jcfg.patch_size) == (32, 1, 8)
    ref = student_params_to_torch(params, jcfg)
    assert set(ref) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(ref[k], v.numpy(), err_msg=k)


def test_converted_checkpoints_predict_as_jax(tfam_ckpt, student_ckpt, teacher, tmp_path):
    """The JAX predictor and the port's on the two converted files (the
    student's with DataParallel's prefix) agree within 1e-4."""
    tfam_out, student_out = str(tmp_path / "best_model.pth"), str(tmp_path / "student.pth")
    convert.convert_tfam(tfam_ckpt, tfam_out)
    convert.convert_student(student_ckpt[0], student_out, module_prefix=True)
    _, jstudent = student_params_from_checkpoint(student_out)
    cfg, tower = student_visual_state_from_checkpoint(student_out)
    assert cfg == ClipVisionConfig(**VGEOM)
    jv, pv = JVision(**VGEOM), ClipVisionConfig(**VGEOM)
    kw = dict(num_classes=C, frame_batch=8, length_bucket=8, half_precision=False)
    jpred = JPredictor(
        teacher_params=teacher, teacher_config=jv, student_params=jstudent["visual_encoder"],
        student_config=jv, tfam_config=JTFAMConfig(**TGEOM),
        tfam_params=tfam_params_from_checkpoint(tfam_out, num_layers=LAYERS, d_model=D), **kw)
    ppred = ViMoCLIPPredictor(
        teacher_state=clip_vision_state_from_jax(teacher, pv, prefix=""), teacher_config=pv,
        student_state=tower, student_config=pv, tfam_state=tfam_state_from_checkpoint(tfam_out),
        tfam_config=TFAMModelConfig(**TGEOM), device="cpu", **kw)
    rng = np.random.default_rng(4)
    videos = [rng.integers(0, 256, (t, 36, 48, 3), dtype=np.uint8) for t in (9, 14)]
    for r, g in zip(jpred.predict_videos(videos), ppred.predict_videos(videos)):
        np.testing.assert_allclose(g.probabilities, r.probabilities, atol=1e-4, rtol=0)


@pytest.mark.parametrize("prefix", [False, True], ids=["bare", "module-prefix"])
def test_student_to_torch_matches_jax_convert(student_ckpt, tmp_path, prefix):
    ckpt, weights = student_ckpt
    got = convert.convert_student(ckpt, str(tmp_path / "port.pth"), module_prefix=prefix)
    orbax = tmp_path / "orbax"
    mgr = JCheckpointManager(str(orbax))
    mgr.save(JTrainState.create(student_params_from_torch(weights, JVision(**VGEOM)),
                                jax_make_adam(1e-3)), "best")
    mgr.wait_until_finished()
    ref = jax_convert.convert_student(str(orbax), str(tmp_path / "jax.pth"),
                                      module_prefix=prefix)
    assert ref.keys() == got.keys()
    for k, v in got.items():
        assert ref[k].shape == v.shape, k
        np.testing.assert_array_equal(ref[k].numpy(), v.numpy(), err_msg=k)


def test_orbax_directory_is_refused(tmp_path, teacher):
    mgr = JCheckpointManager(str(tmp_path / "orbax"))
    mgr.save(JTrainState.create(teacher, jax_make_adam(1e-3)), "best")
    mgr.wait_until_finished()
    for fn in (convert.convert_tfam, convert.convert_student):
        with pytest.raises(SystemExit, match="Orbax.*`vimo-convert`"):
            fn(str(tmp_path / "orbax"), str(tmp_path / "x.pth"))
    with pytest.raises(SystemExit, match=r"no checkpoint 'step_9'.*\['best'\]"):
        convert.convert_tfam(str(tmp_path / "orbax"), str(tmp_path / "x.pth"), name="step_9")
    assert not (tmp_path / "x.pth").exists()

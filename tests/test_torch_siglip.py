"""The SigLIP vision tower (``models/siglip_vit.py``) and its place in the
port's entry points, at a tiny size on the CPU in float32: against the
benchmark's plain reference (``perfbench/reference/siglip.py``) and against
``transformers``' ``SiglipVisionModel`` on the same weights; the squash
preprocessing; the serving cascade against the plain cascade; the
predictor's frame counters; the towers' spans; the factory behind
extraction, export and the student; loading HF SigLIP files."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import weights
from perfbench.reference import siglip as ref_siglip
from perfbench.reference import tfam as ref_tfam
from perfbench.reference import vit as ref_vit
from vimoclip_tpu_torch.config import TFAMModelConfig
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.models.siglip_vit import SiglipVisionConfig, SiglipVisionEncoder
from vimoclip_tpu_torch.models.towers import preprocess, tower_state, vision_tower
from vimoclip_tpu_torch.ops.preprocess import clip_preprocess
from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

SPEC = {"image_size": 28, "patch_size": 14, "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 96, "layer_norm_eps": 1e-6}
CFG = SiglipVisionConfig(**SPEC)
TFAM_SPEC = {"d_model": 64, "nhead": 4, "num_layers": 2, "dim_feedforward": 128,
             "use_cross_attention": True, "use_pe": False, "concat_dim": 1, "dropout": 0.1,
             "mlp_dropout": 0.1, "activation": "relu", "attention_impl": "xla"}
CLASSES = 7


def _params(spec=SPEC, salt=1):
    return weights.make_params(ref_siglip.param_shapes(spec), weights.generator(5, salt, "cpu"))


def _frames(n, h=48, w=72, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))


def _tower(params, cfg=CFG):
    tower = vision_tower(cfg).eval()
    tower.load_state_dict(tower_state(cfg, params), strict=True)
    return tower


def test_tower_equals_the_plain_reference():
    params = _params()
    frames = _frames(3)
    with torch.no_grad():
        got = _tower(params)(preprocess(frames, CFG))
    want = ref_siglip.embed(params, SPEC, frames)
    assert isinstance(_tower(params), SiglipVisionEncoder) and got.shape == (3, 64)
    # float32 both, the same products summed in other orders (the patch
    # embedding as one matmul, packed q/k/v): ~1e-6 of outputs of ~1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("image_size", [28, 32], ids=["whole", "pixels_over"])
def test_tower_equals_transformers(image_size):
    transformers = pytest.importorskip("transformers")
    hc = transformers.SiglipVisionConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
        image_size=image_size, patch_size=14, layer_norm_eps=1e-6,
        hidden_act="gelu_pytorch_tanh")
    torch.manual_seed(0)
    hf = transformers.SiglipVisionModel(hc).eval()
    cfg = dataclasses.replace(CFG, image_size=image_size)
    tower = _tower(hf.state_dict(), cfg)
    pixels = torch.randn(3, image_size, image_size, 3)
    with torch.no_grad():
        want = hf(pixel_values=pixels.permute(0, 3, 1, 2)).pooler_output
        got = tower(pixels)
    # float32 both; HF's init draws the probe normal(0, 1), so outputs are
    # ~2 in size and differ by summation order alone (~2e-6 seen)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(48, 72), (360, 640), (28, 28)], ids=str)
def test_squash_preprocessing_equals_the_reference(hw):
    frames = _frames(2, *hw)
    got = clip_preprocess(frames, 28, resize="squash", mean=CFG.image_mean,
                          std=CFG.image_std)
    want = ref_siglip.preprocess(frames, 28)
    # float32; the port slices off input pixels the weights never reach and
    # 28x28 frames take K5's plain version, (x - 127.5) * (1 / 127.5): ulps
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    assert torch.equal(preprocess(frames, CFG), got)


def test_clip_preprocessing_is_the_default_rule():
    frames = _frames(2)
    cfg = ClipVisionConfig(image_size=32)
    assert torch.equal(preprocess(frames, cfg), clip_preprocess(frames, 32))
    with pytest.raises(ValueError, match="resize rule"):
        clip_preprocess(frames, 32, resize="pad")


def _predictor(**kw):
    teacher, student = _params(salt=1), _params(salt=2)
    tfam = weights.make_params(ref_tfam.param_shapes(TFAM_SPEC, CLASSES),
                               weights.generator(5, 3, "cpu"))
    pred = ViMoCLIPPredictor(teacher, CFG, student, CFG, tfam, TFAMModelConfig(**TFAM_SPEC),
                             num_classes=CLASSES, frame_batch=4, length_bucket=4,
                             max_seq_len=64, half_precision=False, device="cpu", **kw)
    return pred, teacher, student, tfam


def test_cascade_equals_the_plain_cascade():
    pred, teacher, student, tfam = _predictor()
    frames = _frames(9)
    got = pred.predict_videos([frames.numpy()])[0].probabilities
    rgb = ref_siglip.embed(teacher, SPEC, frames)
    mot = ref_siglip.embed(student, SPEC, ref_vit.frame_diff(frames))
    no = lambda t: torch.zeros(t.shape[0], dtype=torch.bool)
    logits = ref_tfam.row_logits(tfam, TFAM_SPEC, rgb[None], mot[None], no(rgb), no(mot),
                                 None, None, 0)
    want = torch.sigmoid(logits.double())[0].numpy()
    assert pred.embed_dim == 64
    # float32 throughout; the program pads to the bucket and masks
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_the_predictor_counts_each_towers_frames():
    pred = _predictor()[0]
    assert pred.stats()["teacher_frames"] == pred.stats()["student_frames"] == 0
    pred.predict_videos([_frames(9).numpy()])
    assert (pred.stats()["teacher_frames"], pred.stats()["student_frames"]) == (9, 8)
    # two clips of one resolution share the windows: the student also runs
    # the one difference across their edge, which the cascade drops
    pred.predict_videos([_frames(5).numpy(), _frames(6, seed=1).numpy()])
    assert (pred.stats()["teacher_frames"], pred.stats()["student_frames"]) == (20, 18)


def _span_counts(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.name for e in prof.events()]
    return {n: names.count(n) for n in ("vimo.tower.attn", "vimo.tower.head",
                                        "vimo.attn.fwd")}


def test_the_towers_spans():
    siglip = _tower(_params())
    clip = ClipVisionEncoder(ClipVisionConfig(image_size=32, patch_size=16, hidden_size=32,
                                              num_layers=3, num_heads=2,
                                              intermediate_size=64)).eval()
    with torch.no_grad():
        got = _span_counts(lambda: siglip(torch.zeros(2, 28, 28, 3)))
        assert got == {"vimo.tower.attn": 2, "vimo.tower.head": 1, "vimo.attn.fwd": 0}
        got = _span_counts(lambda: clip(torch.zeros(2, 32, 32, 3)))
        assert got == {"vimo.tower.attn": 3, "vimo.tower.head": 0, "vimo.attn.fwd": 0}
        # TFAM's attention keeps its own span on the kernels' route alone
        pred = _predictor()[0]
        pred.tfam.layers[0].self_attn.implementation = "flash"
        got = _span_counts(lambda: pred.predict_videos([_frames(6).numpy()]))
    assert got["vimo.tower.attn"] == 2 * 2 * 2 and got["vimo.tower.head"] == 2 * 2
    assert got["vimo.attn.fwd"] == 1


def test_extraction_export_and_the_student_build_siglip_towers():
    from vimoclip_tpu_torch.export import MotionEmbeddingExporter
    from vimoclip_tpu_torch.extraction import ClipExtractor
    from vimoclip_tpu_torch.models.student import StudentModel

    params = _params()
    frames = _frames(3)
    want = ref_siglip.embed(params, SPEC, frames)
    extractor = ClipExtractor(params, CFG, batch_size=4, half_precision=False, device="cpu")
    assert isinstance(extractor.encoder, SiglipVisionEncoder)
    torch.testing.assert_close(extractor._embed(frames), want, rtol=1e-4, atol=1e-5)
    exporter = MotionEmbeddingExporter(params, CFG, chunk_size=4, half_precision=False,
                                       device="cpu")
    np.testing.assert_allclose(exporter._embed_chunk(frames.numpy()), want.numpy(),
                               rtol=1e-4, atol=1e-5)
    student = StudentModel(CFG, num_classes=CLASSES).eval()
    assert isinstance(student.visual_encoder, SiglipVisionEncoder)
    student.visual_encoder.load_state_dict(tower_state(CFG, params), strict=True)
    with torch.no_grad():
        emb, distill, logits = student(frames[None])
    torch.testing.assert_close(emb[0], want, rtol=1e-4, atol=1e-5)
    assert distill.shape == (1, 3, 64) and logits.shape == (1, CLASSES)


def test_a_siglip_student_checkpoint_names_its_tower(tmp_path):
    from vimoclip_tpu_torch.models.convert import (
        student_visual_state_from_checkpoint,
        to_tensors,
    )
    from vimoclip_tpu_torch.models.student import StudentModel

    student = StudentModel(CFG, num_classes=CLASSES)
    torch.save({"state_dict": student.state_dict()}, tmp_path / "student_best.pth")
    cfg, state = student_visual_state_from_checkpoint(str(tmp_path / "student_best.pth"))
    # the shapes give all but the head count, which falls back to hidden / 64
    # for a width no SigLIP tower was published at (--student-clip-weights
    # names it)
    assert type(cfg) is SiglipVisionConfig and cfg.num_heads == 1
    assert dataclasses.replace(cfg, num_heads=CFG.num_heads) == CFG
    vision_tower(cfg).load_state_dict(to_tensors(tower_state(cfg, state)), strict=True)


def test_the_siglip_tower_refuses_token_merging():
    with pytest.raises(ValueError, match="token merging"):
        vision_tower(dataclasses.replace(CFG, token_merge_r=2))


def _tiny_siglip(transformers):
    vision = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=96, image_size=28, patch_size=14)
    text = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=48, vocab_size=50, max_position_embeddings=16)
    torch.manual_seed(1)
    return transformers.SiglipModel(transformers.SiglipConfig(
        text_config=text, vision_config=vision)).eval()


@pytest.mark.parametrize("form", ["safetensors", "folder"])
def test_an_hf_siglip_checkpoint_loads_strictly(tmp_path, form):
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    from vimoclip_tpu_torch.models.pretrained import load_clip_vision

    model = _tiny_siglip(transformers)
    model.save_pretrained(tmp_path, safe_serialization=True)
    source = tmp_path / "model.safetensors" if form == "safetensors" else tmp_path
    cfg, state = load_clip_vision(str(source))
    assert cfg == SiglipVisionConfig(image_size=28, patch_size=14, hidden_size=64,
                                     num_layers=2, num_heads=4, intermediate_size=96)
    tower = vision_tower(cfg).eval()
    tower.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    pixels = torch.randn(2, 28, 28, 3)
    with torch.no_grad():
        want = model.vision_model(pixel_values=pixels.permute(0, 3, 1, 2)).pooler_output
        got = tower(pixels)
    # float32 both, summation order alone
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_an_hf_clip_checkpoint_still_loads_as_clip(tmp_path):
    transformers = pytest.importorskip("transformers")
    from vimoclip_tpu_torch.models.pretrained import load_clip_vision

    vision = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                  intermediate_size=96, image_size=32, patch_size=16)
    text = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=48, vocab_size=50, max_position_embeddings=16)
    torch.manual_seed(2)
    model = transformers.CLIPModel(transformers.CLIPConfig(
        text_config=text, vision_config=vision, projection_dim=24)).eval()
    model.save_pretrained(tmp_path, safe_serialization=True)
    cfg, state = load_clip_vision(str(tmp_path / "model.safetensors"))
    assert type(cfg) is ClipVisionConfig and cfg.embed_dim == 24 and cfg.num_heads == 1
    tower = vision_tower(cfg).eval()
    assert type(tower) is ClipVisionEncoder
    tower.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    pixels = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        want = model.get_image_features(pixel_values=pixels.permute(0, 3, 1, 2))
        got = tower(pixels)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)

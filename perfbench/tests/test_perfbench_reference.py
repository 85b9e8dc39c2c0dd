"""The references against the port at small sizes on the CPU: whole runs
of every cell (the program's float32 CPU path for training; bf16 towers
for serving), and the plain tower and preprocessing against the port's
float32 ones directly."""

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import precision, seeding
from perfbench.reference import vit as ref_vit
from perfbench.tests import small

# a sound small run reads far under each cell's limits; these are the
# readings' own scale at the small sizes (bf16 towers, float32 training)
SOUND = {"emb_cos_dist": 1e-4, "logit_cos_dist": 1e-4, "loss_gap": 1e-5,
         "grad_gap": 1e-5, "change_gap": 1e-4}


@pytest.mark.parametrize("cell", [w["name"] for w in small.bench()["workloads"]])
def test_a_sound_small_run_is_correct(cell):
    line = small.run(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    for name, value in line["numbers"].items():
        if name in SOUND:
            assert value < SOUND[name], (name, value)


def test_plain_tower_equals_the_ports_float32_tower():
    from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
    from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

    b = small.bench()
    spec = small.config(b, "vimoclip-ak")["teacher"]
    params = weights.make_params(ref_vit.param_shapes(spec), weights.generator(3, 1, "cpu"))
    port = ClipVisionEncoder(ClipVisionConfig(**spec))
    port.load_state_dict(params, strict=True)
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 48, 72, 3),
                                                                dtype=np.uint8))
    with torch.no_grad():
        want = port(clip_preprocess(frames, spec["image_size"]))
    got = ref_vit.embed(params, spec, frames)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_plain_frame_difference_equals_the_ports():
    from vimoclip_tpu_torch.ops.preprocess import frame_diff

    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (5, 64, 64, 3),
                                                                dtype=np.uint8))
    assert torch.equal(ref_vit.frame_diff(frames), frame_diff(frames))


def test_seeding_copies_equal_the_ports_rules():
    from vimoclip_tpu_torch.ops.kernels.flash_attention import dropout_keep_mask
    from vimoclip_tpu_torch.prng import KeyChain

    assert seeding.stream_seed(2**31 + 5, "dropout", 3) == KeyChain(2**31 + 5).seed("dropout", 3)
    seed = torch.tensor([[7, -3, 2**31 - 1]], dtype=torch.int32)
    want = dropout_keep_mask(seed, 9, 13, 0.1)[0]
    assert torch.equal(seeding.philox_keep(seed[0], 9, 13, 0.1), want)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12)])
    assert precision.round_tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]

"""The port's config loader against the JAX package's on the same YAML."""

import dataclasses
from pathlib import Path

import pytest
import yaml

from vimoclip_tpu import config as jcfg
from vimoclip_tpu_torch import config as tcfg

ROOT = Path(__file__).resolve().parents[1]


def _fields(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("name", ["example_ak_frame_diff.yaml", "example_mammalnet.yaml"])
def test_repo_configs_load_the_same(name):
    path = str(ROOT / "configs" / name)
    ours, theirs = tcfg.load_experiment_config(path), jcfg.load_experiment_config(path)
    for section in ("logging", "data", "model"):
        assert _fields(getattr(ours, section)) == _fields(getattr(theirs, section))
    t, j = _fields(ours.training), _fields(theirs.training)
    assert t.pop("device") == "cuda" and j.pop("device") == "tpu"
    assert t == j


def _write(tmp_path, doc):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def test_tpu_fields_parsed_not_dropped(tmp_path, caplog):
    doc = {
        "training": {"device": "tpu", "dropout_rng_impl": "threefry2x32",
                     "lr": "3e-4", "parallelism": {"data": 1, "microbatches": 4}},
        "data": {"length_bucket": 64, "max_seq_len": 512, "bogus": 1},
        "model": {"attention_impl": "flash", "d_model": 256},
        "testing": {"x": 1},
    }
    path = _write(tmp_path, doc)
    ours, theirs = tcfg.load_experiment_config(path), jcfg.load_experiment_config(path)
    assert ours.training.device == "cuda"
    assert ours.training.dropout_rng_impl == theirs.training.dropout_rng_impl
    assert ours.training.lr == theirs.training.lr == 3e-4
    assert ours.training.pipeline_microbatches == 4
    assert ours.data.length_bucket == 64 and ours.data.max_seq_len == 512
    assert _fields(ours.model) == _fields(theirs.model)
    logged = caplog.text
    assert "bogus" in logged and "testing" in logged


@pytest.mark.parametrize("doc, exc, words", [
    ({"training": {"parallelism": {"seq": "two"}}}, ValueError, "must be an integer"),
    ({"training": {"parallelism": [2, 2]}}, ValueError, "must be a mapping"),
    ({"model": {"attention_impl": "pallas"}}, ValueError, "attention_impl"),
    ({"training": {"data_parallel": 0}}, ValueError, "data_parallel must be -1"),
    ({"training": {"model_parallel": 0}}, ValueError, "model_parallel >= 1"),
    ({"training": {"device": "gpu0"}}, ValueError, "device"),
])
def test_refusals_name_their_slice(tmp_path, doc, exc, words):
    with pytest.raises(exc, match=words):
        tcfg.load_experiment_config(_write(tmp_path, doc))


@pytest.mark.parametrize("doc", [
    {"model": {"attention_impl": "ring"}},
    {"model": {"attention_impl": "ring_inner"}},
    {"training": {"parallelism": {"seq": 2}}},
    {"training": {"pipeline_parallel": 2, "parallelism": {"microbatches": 4}}},
])
def test_seq_and_pipe_parse_as_jax(tmp_path, doc):
    """The settings slice 7b lifted load in both packages to equal fields;
    whether the ranks match is the trainer's check."""
    path = _write(tmp_path, doc)
    ours, theirs = tcfg.load_experiment_config(path), jcfg.load_experiment_config(path)
    assert _fields(ours.model) == _fields(theirs.model)
    for field in ("seq_parallel", "pipeline_parallel", "pipeline_microbatches"):
        assert getattr(ours.training, field) == getattr(theirs.training, field), field


def test_data_parallel_parses_and_the_trainer_wants_its_ranks(tmp_path):
    """``training.data_parallel: 4`` parses in both packages since slice 7a;
    a lone process (no ``torchrun``) asking for four ranks is refused by the
    trainer with the command to run, before any data is read."""
    from vimoclip_tpu_torch.train.tfam_trainer import TFAMTrainer

    path = _write(tmp_path, {"training": {"data_parallel": 4, "device": "cpu"},
                             "data": {"train_dataset_path": "missing.h5"}})
    ours, theirs = tcfg.load_experiment_config(path), jcfg.load_experiment_config(path)
    assert ours.training.data_parallel == theirs.training.data_parallel == 4
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4 -m "
                                         "vimoclip_tpu_torch.cli.tfam_train_eval"):
        TFAMTrainer(ours, str(tmp_path / "logs"), str(tmp_path / "ck"))

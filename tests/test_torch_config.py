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
    ({"model": {"attention_impl": "ring"}}, NotImplementedError, "multi-GPU"),
    ({"model": {"attention_impl": "ring_inner"}}, NotImplementedError, "multi-GPU"),
    ({"model": {"attention_impl": "pallas"}}, ValueError, "attention_impl"),
    ({"training": {"parallelism": {"seq": 2}}}, NotImplementedError, "multi-GPU"),
    ({"training": {"data_parallel": 4}}, NotImplementedError, "multi-GPU"),
    ({"training": {"device": "gpu0"}}, ValueError, "device"),
])
def test_refusals_name_their_slice(tmp_path, doc, exc, words):
    with pytest.raises(exc, match=words):
        tcfg.load_experiment_config(_write(tmp_path, doc))

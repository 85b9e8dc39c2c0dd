"""Configuration: the stage-2 YAML schema and its typed dataclasses.

The port's copy of ``vimoclip_tpu/config.py`` (``TrainingConfig``,
``LoggingConfig``, ``DataConfig``, ``TFAMModelConfig``,
``load_experiment_config``). One YAML file gives equal field values in both
packages. The fields that exist for the TPU or for XLA are parsed, never
dropped:

- ``training.device: tpu`` maps to ``cuda``; anything but tpu/cuda/cpu raises.
- ``training.dropout_rng_impl`` is kept as read and not acted on. It names
  a JAX bit generator; the port's dropout draws from ``torch.Generator``
  streams (``prng.KeyChain``) and the kernels' Philox bits whatever it says.
- ``training.parallelism`` / the flat ``*_parallel`` keys fill the same
  fields. ``data``, ``model``, ``seq`` and ``pipe`` (with
  ``microbatches``) run over ``torch.distributed`` (``parallel/``, one
  process per GPU under ``torchrun``).
- ``data.length_bucket`` keeps its meaning: serving rounds sequence lengths
  up to it, so a handful of shapes cover every request.
- ``model.attention_impl: ring | ring_inner`` is ring attention over the
  trainer's ``seq`` group (``ops/attention.py``); the trainer sets it
  itself under ``training.parallelism.seq``.

Keys the schema does not know are logged and ignored (the reference's
``testing:`` block and similar), never dropped without a word.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from datetime import datetime
from typing import Any

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainingConfig:
    mode: str = "both"  # train | test | both
    seed: int = 49
    lr: float = 1e-4
    weight_decay: float = 0.1
    eta_min: float = 1e-6
    epochs: int = 30
    batch_size: int = 8
    num_workers: int = 4
    device: str = "cuda"  # YAML "tpu" (the JAX package's default) maps here
    loss: str = "bce"
    metric: str = "map"
    device_metric: bool = False
    dropout_rng_impl: str = "rbg"  # recorded; see the module docstring
    data_parallel: int = -1
    model_parallel: int = 1
    seq_parallel: int = 1
    pipeline_parallel: int = 1
    pipeline_microbatches: int | None = None
    grad_accum: int = 1
    half_precision: bool = False
    resume: bool = False
    checkpoint_every_steps: int | None = None
    keep_checkpoints: int | None = None
    async_checkpoint: bool = False


@dataclasses.dataclass
class LoggingConfig:
    log_dir: str = "logs"
    checkpoint_dir: str = "checkpoints"


@dataclasses.dataclass
class DataConfig:
    num_classes: int = 140
    class_names_dir: str = ""
    train_dataset_path: str = ""
    val_dataset_path: str = ""
    flow_dataset_path: str = ""
    frame_diff_dataset_path: str = ""
    num_frames: int | None = None
    max_frames: int | None = None
    # Sequence lengths round up to multiples of this, so serving sees a
    # handful of shapes instead of one per request.
    length_bucket: int = 128
    max_seq_len: int | None = None

    @property
    def motion_dataset_path(self) -> str:
        return self.flow_dataset_path or self.frame_diff_dataset_path


@dataclasses.dataclass
class TFAMModelConfig:
    d_model: int = 512
    nhead: int = 8
    num_layers: int = 4
    dim_feedforward: int = 2048
    use_cross_attention: bool = True
    use_pe: bool = False
    use_only_rgb: bool = False
    use_only_flow: bool = False
    concat_dim: int = 1
    dropout: float = 0.1
    mlp_dropout: float = 0.1
    activation: str = "relu"
    masked_pooling: bool = False
    # "xla" = plain matmul -> softmax -> matmul; "flash" = the hand-written
    # CUDA kernel (ops/kernels/flash_attention.py); "auto" = flash for
    # CUDA tensors from the crossover length on (ops/attention.py).
    attention_impl: str = "auto"
    # "split" | "fused" | "fused_qkv": read and checked because the YAML
    # configs both packages share carry it; the port runs one layout.
    head_proj: str = "split"


@dataclasses.dataclass
class ExperimentConfig:
    training: TrainingConfig
    logging: LoggingConfig
    data: DataConfig
    model: TFAMModelConfig
    config_path: str = ""

    @property
    def num_classes(self) -> int:
        return self.data.num_classes


_ATTENTION_IMPLS = ("xla", "flash", "auto", "ring", "ring_inner")


def _build(cls, section: dict[str, Any] | None, where: str):
    section = dict(section or {})
    fields = {f.name: f for f in dataclasses.fields(cls)}
    known = {}
    unknown = sorted(k for k in section if k not in fields)
    if unknown:
        _log.warning("%s: ignoring keys the schema does not know: %s",
                     where, unknown)
    for k, v in section.items():
        if k not in fields:
            continue
        # YAML reads "1e-4" as a string; coerce by declared type
        if fields[k].type in ("float", float) and isinstance(v, str):
            v = float(v)
        if fields[k].type in ("int", int) and isinstance(v, str):
            v = int(v)
        known[k] = v
    return cls(**known)


_PARALLELISM_KEYS = {
    "data": "data_parallel",
    "model": "model_parallel",
    "seq": "seq_parallel",
    "pipe": "pipeline_parallel",
    "microbatches": "pipeline_microbatches",
}


def check_training_config(t: TrainingConfig, path: str = "training") -> TrainingConfig:
    """Map ``tpu`` to ``cuda``; refuse devices the port does not run and
    impossible axis sizes. Whether the axes' product matches the ranks is
    the trainer's check (``parallel/mesh.py::create_mesh``)."""
    device = str(t.device).lower()
    if device == "tpu":
        _log.info("%s: training.device 'tpu' maps to 'cuda' in the port", path)
        device = "cuda"
    if device not in ("cuda", "cpu") and not (device.startswith("cuda:")
                                              and device[5:].isdigit()):
        raise ValueError(
            f"{path}: training.device must be tpu, cuda, cuda:N or cpu; got {t.device!r}"
        )
    t.device = device
    if t.data_parallel == 0 or t.data_parallel < -1 or t.model_parallel < 1:
        raise ValueError(f"{path}: training.data_parallel must be -1 or >= 1 and "
                         f"model_parallel >= 1; got {t.data_parallel}, {t.model_parallel}")
    return t


def check_model_config(m: TFAMModelConfig, where: str = "model") -> TFAMModelConfig:
    """Refuse settings the port does not know."""
    if m.attention_impl not in _ATTENTION_IMPLS:
        raise ValueError(
            f"{where}: attention_impl must be one of {_ATTENTION_IMPLS}; "
            f"got {m.attention_impl!r}"
        )
    if m.head_proj not in ("split", "fused", "fused_qkv"):
        raise ValueError(f"{where}: unknown head_proj {m.head_proj!r}")
    return m


def load_experiment_config(path: str) -> ExperimentConfig:
    import yaml

    with open(path, "r") as f:
        cfg = yaml.safe_load(f) or {}
    training_section = dict(cfg.get("training") or {})
    par = training_section.pop("parallelism", None)
    if par is None:
        par = {}
    if not isinstance(par, dict):
        raise ValueError(
            f"{path}: training.parallelism must be a mapping with keys "
            f"{sorted(_PARALLELISM_KEYS)}, got {par!r}"
        )
    for key, field in _PARALLELISM_KEYS.items():
        value = par.get(key)
        if value is None:
            continue
        try:
            training_section[field] = int(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"{path}: training.parallelism.{key} must be an integer, "
                f"got {value!r}"
            ) from None
    unknown = set(par) - set(_PARALLELISM_KEYS)
    if unknown:
        _log.warning(
            "training.parallelism: ignoring unknown keys %s (known: %s)",
            sorted(unknown), sorted(_PARALLELISM_KEYS),
        )
    unknown_sections = sorted(
        set(cfg) - {"training", "logging", "data", "model"}
    )
    if unknown_sections:
        _log.warning("%s: ignoring sections %s", path, unknown_sections)
    training = check_training_config(
        _build(TrainingConfig, training_section, "training"), path
    )
    return ExperimentConfig(
        training=training,
        logging=_build(LoggingConfig, cfg.get("logging"), "logging"),
        data=_build(DataConfig, cfg.get("data"), "data"),
        model=check_model_config(
            _build(TFAMModelConfig, cfg.get("model"), "model"), path
        ),
        config_path=path,
    )


def derive_run_dirs(config: ExperimentConfig, run_name: str | None = None) -> tuple[str, str]:
    """Timestamped run dirs ``<config_name>/{logs,checkpoints}/<run_name>``
    (reference TFAM/train_and_eval.py:366-371), created."""
    run_name = run_name or datetime.now().strftime("%Y%m%d-%H%M%S")
    base = config.config_path.split(".yaml")[0] if config.config_path else "run"
    log_dir = os.path.join(base, config.logging.log_dir, run_name)
    ckpt_dir = os.path.join(base, config.logging.checkpoint_dir, run_name)
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    return log_dir, ckpt_dir

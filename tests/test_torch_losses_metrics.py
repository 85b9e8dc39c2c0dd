"""The port's losses and metrics against the JAX package's, on the CPU,
including a class with no positive and tied scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimoclip_tpu import losses as jax_losses
from vimoclip_tpu import metrics as jax_metrics
from vimoclip_tpu_torch import losses, metrics

torch.set_num_threads(1)


def _data(seed=0, b=6, c=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, c)).astype(np.float32) * 3
    labels = (rng.random((b, c)) < 0.4).astype(np.float32)
    labels[:, 2] = 0.0  # a class with no positive
    logits[:, 4] = np.round(logits[:, 4])  # ties
    logits[1] = logits[0]
    return logits, labels


@pytest.mark.parametrize("pos_weight", [None, 3.0])
def test_bce_and_classification_loss_match_jax(pos_weight):
    logits, labels = _data()
    t = torch.from_numpy
    pw = None if pos_weight is None else np.full(5, pos_weight, np.float32)
    got = losses.bce_with_logits(t(logits), t(labels), None if pw is None else t(pw))
    want = jax_losses.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                      None if pw is None else jnp.asarray(pw))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got = losses.classification_loss(t(logits), t(labels), pos_weight)
    want = jax_losses.classification_loss(jnp.asarray(logits), jnp.asarray(labels), pos_weight)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    ref = torch.nn.functional.binary_cross_entropy_with_logits(t(logits), t(labels))
    if pos_weight is None:
        np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)


@pytest.mark.parametrize("targets", ["one_hot", "index"])
def test_cross_entropy_matches_jax(targets):
    logits, _ = _data(1)
    idx = np.array([0, 3, 1, 4, 2, 2])
    y = np.eye(5, dtype=np.float32)[idx] if targets == "one_hot" else idx
    got = losses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(y))
    want = jax_losses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    ref = torch.nn.functional.cross_entropy(torch.from_numpy(logits), torch.from_numpy(idx))
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_average_precision_matches_jax(seed):
    logits, labels = _data(seed)
    assert metrics.average_precision_np(logits, labels) == \
        jax_metrics.average_precision_np(logits, labels)
    assert metrics.average_precision_np(logits, np.zeros_like(labels)) == 0.0
    ours, theirs = metrics.MultilabelAveragePrecision(5), jax_metrics.MultilabelAveragePrecision(5)
    for part in (slice(0, 2), slice(2, 6)):
        ours.update(logits[part], labels[part])
        theirs.update(logits[part], labels[part])
    assert ours.compute() == theirs.compute()
    with pytest.raises(ValueError):
        ours.update(logits[:, :3], labels[:, :3])


def test_device_average_precision_matches_jax():
    logits, labels = _data(3)
    ours = metrics.DeviceMultilabelAveragePrecision(5)
    theirs = jax_metrics.DeviceMultilabelAveragePrecision(5)
    for part in (slice(0, 3), slice(3, 6)):
        ours.update(torch.from_numpy(logits[part]), torch.from_numpy(labels[part]))
        theirs.update(jnp.asarray(logits[part]), jnp.asarray(labels[part]))
    np.testing.assert_allclose(ours.compute(), theirs.compute(), rtol=1e-6)
    small = metrics.DeviceMultilabelAveragePrecision(5, capacity=4)
    with pytest.raises(RuntimeError):
        small.update(torch.from_numpy(logits), torch.from_numpy(labels))


@pytest.mark.parametrize("top_k", [1, 2])
def test_top_k_accuracy_matches_jax(top_k):
    logits, _ = _data(4)
    idx = np.array([0, 3, 1, 4, 2, 2])
    for y in (idx, np.eye(5, dtype=np.float32)[idx]):
        ours, theirs = metrics.TopKAccuracy(top_k), jax_metrics.TopKAccuracy(top_k)
        ours.update(logits, y)
        theirs.update(logits, y)
        assert ours.compute() == theirs.compute()

"""The port's embedding data path against the JAX package's, on the CPU: the
same HDF5 files (AK flat and MN nested layouts) give equal items, batches and
masks from both packages, batch for batch over shuffled epochs."""

import numpy as np
import pytest
import torch

from vimoclip_tpu.data import EmbeddingWriter
from vimoclip_tpu.data import embedding_dataset as jax_ds
from vimoclip_tpu.data import hdf5_schema as jax_h5
from vimoclip_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from vimoclip_tpu_torch.data import embedding_dataset as port_ds
from vimoclip_tpu_torch.data import hdf5_schema as port_h5
from vimoclip_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device

torch.set_num_threads(1)
D, C = 8, 5


def _write(tmp_path, nested: bool, n: int = 11, seed: int = 0):
    rng = np.random.default_rng(seed)
    rgb, mot = str(tmp_path / "rgb.h5"), str(tmp_path / "mot.h5")
    prefix = "trimmed_videos" if nested else None
    with EmbeddingWriter(rgb, num_classes=C, embed_dim=D, nested_prefix=prefix) as wr, \
         EmbeddingWriter(mot, embed_dim=D) as wm:
        for i in range(n):
            t = int(rng.integers(3, 30))
            labels = (rng.random(C) < 0.4).astype(np.float32)
            wr.write_video(f"v{i:02d}.mp4", rng.standard_normal((t, D)), labels=labels)
            wm.write_video(f"v{i:02d}", rng.standard_normal((t - 1, D)))
    return rgb, mot


@pytest.mark.parametrize("nested", [False, True], ids=["ak_flat", "mn_nested"])
@pytest.mark.parametrize("num_frames, max_frames", [(None, None), (7, 25)])
def test_dataset_items_match_jax(tmp_path, nested, num_frames, max_frames):
    rgb, mot = _write(tmp_path, nested)
    ours = port_ds.PairedEmbeddingDataset(rgb, mot, num_frames=num_frames,
                                          max_frames=max_frames)
    theirs = jax_ds.PairedEmbeddingDataset(rgb, mot, num_frames=num_frames,
                                           max_frames=max_frames)
    assert ours.keys == theirs.keys and len(ours) == len(theirs) > 0
    if nested:
        assert all(k.startswith("trimmed_videos/") for k in ours.keys)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["video_id"] == b["video_id"]
        for key in ("embeddings", "motion_embeddings", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
    ours.close()
    theirs.close()


@pytest.mark.parametrize("bucket, cap", [(None, None), (8, None), (8, 16)])
def test_loader_batches_match_jax(tmp_path, bucket, cap):
    rgb, mot = _write(tmp_path, nested=False, n=13)
    ours = port_ds.PairedEmbeddingDataset(rgb, mot)
    theirs = jax_ds.PairedEmbeddingDataset(rgb, mot)
    loaders = [
        cls(ds, 4, lambda items, f=f: f(items, bucket=bucket, max_seq_len=cap),
            shuffle=True, drop_last=True, seed=49, num_workers=workers)
        for cls, ds, f, workers in ((BatchLoader, ours, port_ds.collate_pad, 2),
                                    (JaxBatchLoader, theirs, jax_ds.collate_pad, 1))
    ]
    assert len(loaders[0]) == len(loaders[1]) == 3
    for epoch, start in ((0, 0), (1, 0), (2, 1)):
        for loader in loaders:
            loader.set_epoch(epoch, start_batch=start)
        got, want = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == 3 - start
        for a, b in zip(got, want):
            assert a["video_id"] == b["video_id"]
            for key in ("embeddings", "motion_embeddings", "labels", "mask_rgb",
                        "mask_motion"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_hdf5_readers_match_jax(tmp_path):
    rgb, _ = _write(tmp_path, nested=True)
    for fn, args in (("list_video_keys", (rgb, "trimmed_videos")),
                     ("sequence_lengths", (rgb, "trimmed_videos")),
                     ("read_embeddings", (rgb, "trimmed_videos/v03.mp4", 1, 4)),
                     ("read_labels", (rgb, "trimmed_videos/v03.mp4"))):
        a, b = getattr(port_h5, fn)(*args), getattr(jax_h5, fn)(*args)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_sparse_sample_indices_match_jax():
    for total, n in ((10, 4), (100, 16), (5, 5), (7, 1)):
        np.testing.assert_array_equal(port_ds.sparse_sample_indices(total, n),
                                      jax_ds.sparse_sample_indices(total, n))


def test_prefetch_to_device_keeps_order_and_ids():
    batches = [{"video_id": [f"v{i}"], "x": np.full((2, 3), i, np.float32)}
               for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu"))
    assert [b["video_id"] for b in out] == [b["video_id"] for b in batches]
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))

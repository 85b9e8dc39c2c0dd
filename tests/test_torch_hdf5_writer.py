"""The port's HDF5 writers and structure checks against the JAX package's:
round trips, streaming appends and resume, an explicit zero
``original_frames``, ``AsyncWriter`` errors, the ``video_ids`` rebuilt on an
append-resume, files of either package read through the other's readers,
``analyze_structure``, and the checker CLI's exit codes."""

import json
import time

import h5py
import numpy as np
import pytest

import vimoclip_tpu.data.hdf5_schema as jh
import vimoclip_tpu_torch.data.hdf5_schema as th
from vimoclip_tpu.cli.h5_structure_checker import main as jax_checker
from vimoclip_tpu_torch.cli import h5_structure_checker

PACKAGES = {"port": th, "jax": jh}
D, C = 8, 5


def _video(rng, t):
    return (rng.standard_normal((t, D)).astype(np.float32),
            (rng.random(C) < 0.5).astype(np.float32))


def _write(mod, path, nested=None, compression="gzip"):
    """Two whole videos and one streamed in three chunks."""
    rng = np.random.default_rng(0)
    with mod.EmbeddingWriter(path, num_classes=C, split="train", embed_dim=D,
                             nested_prefix=nested, compression=compression) as w:
        for vid, t in (("a.mp4", 4), ("b.mp4", 7)):
            emb, labels = _video(rng, t)
            w.write_video(vid, emb, labels, original_frames=t + 1)
        emb, labels = _video(rng, 9)
        s = w.open_stream("c.mp4", chunk_rows=4)
        for i in range(0, 9, 4):
            s.append(emb[i:i + 4])
        s.finalize(labels=labels, original_frames=0)  # an explicit zero is kept


def _dump(path):
    def walk(g):
        out = {"attrs": {k: (v.tolist() if hasattr(v, "tolist") else v)
                         for k, v in g.attrs.items()}}
        for k, v in g.items():
            if isinstance(v, h5py.Group):
                out[k] = walk(v)
            else:
                out[k] = (v[:].tolist() if v.dtype.kind != "O" else list(v.asstr()[:]),
                          str(v.dtype), v.chunks, v.compression, v.maxshape)
        return out

    with h5py.File(path, "r") as f:
        return walk(f)


@pytest.mark.parametrize("nested", [None, "trimmed_videos"], ids=["ak", "mn"])
@pytest.mark.parametrize("compression", ["gzip", None], ids=["gzip", "raw"])
def test_writer_matches_jax_bit_for_bit(tmp_path, nested, compression):
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.h5")
        _write(mod, paths[name], nested, compression)
    assert _dump(paths["port"]) == _dump(paths["jax"])
    assert th.analyze_structure(paths["port"]) | {"path": 0} == \
        jh.analyze_structure(paths["jax"]) | {"path": 0}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_files_read_back_through_either_package(tmp_path, writer, reader):
    path = str(tmp_path / "f.h5")
    _write(PACKAGES[writer], path)
    r = PACKAGES[reader]
    assert sorted(r.list_video_keys(path)) == ["a.mp4", "b.mp4", "c.mp4"]
    assert r.sequence_lengths(path) == {"a.mp4": 4, "b.mp4": 7, "c.mp4": 9}
    rng = np.random.default_rng(0)
    for vid, t in (("a.mp4", 4), ("b.mp4", 7), ("c.mp4", 9)):
        emb, labels = _video(rng, t)
        np.testing.assert_array_equal(r.read_embeddings(path, vid), emb)
        np.testing.assert_array_equal(r.read_embeddings(path, vid, 1, 3), emb[1:3])
        np.testing.assert_array_equal(r.read_labels(path, vid), labels)
    with h5py.File(path, "r") as f:
        assert list(f["video_ids"].asstr()[:]) == ["a.mp4", "b.mp4", "c.mp4"]
        assert f["c.mp4"].attrs["original_frames"] == 0
        assert f["c.mp4"].attrs["total_frames"] == 9
        assert f["a.mp4"].attrs["original_frames"] == 5


@pytest.mark.parametrize("explicit_ids", [False, True], ids=["live-groups", "explicit"])
def test_append_resume_rebuilds_video_ids(tmp_path, explicit_ids):
    for name, mod in PACKAGES.items():
        path = str(tmp_path / f"{name}.h5")
        _write(mod, path)
        with mod.EmbeddingWriter(path, mode="a", num_classes=99, embed_dim=D) as w:
            assert w.has_video("a.mp4") and not w.has_video("d.mp4")
            w.write_video("d.mp4", np.ones((2, D), np.float32))
            w.delete_video("b.mp4")
            w.delete_video("never.mp4")  # no group: nothing to do
            w.annotate_error("e.mp4", "decode failed")
            if explicit_ids:
                w.set_video_ids(["a.mp4", "b.mp4", "d.mp4", "missing.mp4"])
        with h5py.File(path, "r") as f:
            ids = list(f["video_ids"].asstr()[:])
            assert f.attrs["num_classes"] == C  # kept on resume
            assert f["e.mp4"].attrs["error"] == "decode failed"
        expect = (["a.mp4", "b.mp4", "d.mp4", "missing.mp4"] if explicit_ids
                  else ["a.mp4", "c.mp4", "d.mp4", "e.mp4"])
        assert ids == expect
    assert _dump(str(tmp_path / "port.h5")) == _dump(str(tmp_path / "jax.h5"))


def test_writer_close_twice_and_empty_file(tmp_path):
    for name, mod in PACKAGES.items():
        w = mod.EmbeddingWriter(str(tmp_path / f"{name}.h5"), num_classes=C)
        w.close()
        w.close()
    assert _dump(str(tmp_path / "port.h5")) == _dump(str(tmp_path / "jax.h5"))
    with h5py.File(str(tmp_path / "port.h5"), "r") as f:
        assert "video_ids" not in f


def _async_run(mod, path):
    rng = np.random.default_rng(1)
    w = mod.AsyncWriter(mod.EmbeddingWriter(path, num_classes=C, embed_dim=D), max_queue=2)
    emb, labels = _video(rng, 5)
    w.submit("whole.mp4", emb, labels, original_frames=6)
    for i in range(0, 5, 2):
        w.submit_chunk("streamed.mp4", emb[i:i + 2])
    w.finalize_video("streamed.mp4", labels=labels)
    w.submit_chunk("aborted.mp4", emb[:2])
    w.abort_video("aborted.mp4")
    w.finalize_video("empty.mp4", labels=labels, original_frames=3)
    w.close()


def test_async_writer_matches_jax(tmp_path):
    for name, mod in PACKAGES.items():
        _async_run(mod, str(tmp_path / f"{name}.h5"))
    ours = _dump(str(tmp_path / "port.h5"))
    assert ours == _dump(str(tmp_path / "jax.h5"))
    assert "aborted.mp4" not in ours
    assert ours["empty.mp4"]["attrs"] == {"total_frames": 0, "original_frames": 3}
    np.testing.assert_array_equal(ours["streamed.mp4"]["embeddings"][0],
                                  ours["whole.mp4"]["embeddings"][0])


@pytest.mark.parametrize("surface", ["submit", "close"])
def test_async_writer_errors_surface(tmp_path, surface):
    """A duplicate group fails on the writer thread; the error is raised by
    the next submit, or by close."""
    for mod in PACKAGES.values():
        w = mod.AsyncWriter(mod.EmbeddingWriter(str(tmp_path / f"{surface}.h5"),
                                                embed_dim=D))
        w.submit("a.mp4", np.zeros((2, D), np.float32))
        w.submit("a.mp4", np.zeros((2, D), np.float32))
        if surface == "submit":
            with pytest.raises(ValueError):
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    w.submit_chunk("b.mp4", np.zeros((1, D), np.float32))
                    time.sleep(0.01)
        with pytest.raises(ValueError):
            w.close()
        assert not w._thread.is_alive()


def _pair(tmp_path, mod, drop_labels=False, extra_root=False):
    paths = []
    for split in ("train", "val"):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}_{split}_{drop_labels}.h5")
        rng = np.random.default_rng(2)
        with mod.EmbeddingWriter(path, num_classes=C, split=split, embed_dim=D) as w:
            for i in range(3):
                emb, labels = _video(rng, 3 + i)
                w.write_video(f"v{i}.mp4", emb,
                              None if drop_labels and split == "val" else labels)
        if extra_root and split == "val":
            with h5py.File(path, "a") as f:
                f.create_dataset("extra", data=np.zeros(3))
        paths.append(path)
    return paths


@pytest.mark.parametrize("case", ["match", "missing-labels", "extra-root-dataset"])
def test_analyze_and_compare_match_jax(tmp_path, case):
    kw = {"drop_labels": case == "missing-labels", "extra_root": case == "extra-root-dataset"}
    a, b = _pair(tmp_path, th, **kw)
    assert th.analyze_structure(a) == jh.analyze_structure(a)
    assert th.analyze_structure(b) == jh.analyze_structure(b)
    ours = th.compare_structures(th.analyze_structure(a), th.analyze_structure(b))
    assert ours == jh.compare_structures(jh.analyze_structure(a), jh.analyze_structure(b))
    assert ours[0] == (case == "match")


@pytest.mark.parametrize("case", ["match", "missing-labels"])
def test_checker_cli_exit_codes_match_jax(tmp_path, capsys, case):
    a, b = _pair(tmp_path, th, drop_labels=case == "missing-labels")
    code = h5_structure_checker.main([a, b])
    ours = capsys.readouterr().out
    assert code == jax_checker([a, b]) == (0 if case == "match" else 1)
    assert ours == capsys.readouterr().out
    assert h5_structure_checker.main([a, b, "--json"]) == code
    report = json.loads(capsys.readouterr().out)
    assert report["match"] is (code == 0) and report["a"]["path"] == a

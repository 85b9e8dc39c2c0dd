"""The port's teacher extraction against the JAX package's on the CPU: the
same videos and weights through both ``ClipExtractor``s and both
``create_hdf5_dataset``s give the same embeddings (float32, atol 1e-4) and
the same groups, attrs, labels and ``video_ids`` (bitwise), with errors,
``max_frames`` (an under-reporting container included), mixed resolutions,
temporal dedup, streaming, abort rollback, sharding + merge, ``--float32``
and the CLI. JAX's mesh case waits for the multi-GPU slice."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vimoclip_tpu.data.video_reader as jvr
import vimoclip_tpu.extraction as jex
import vimoclip_tpu_torch.data.video_reader as tvr
import vimoclip_tpu_torch.extraction as ex
from vimoclip_tpu.cli.extract_embeddings import main as jax_cli
from vimoclip_tpu.cli.h5_merge import merge as jax_merge
from vimoclip_tpu.data.hdf5_schema import analyze_structure as jax_analyze
from vimoclip_tpu.data.hdf5_schema import compare_structures as jax_compare
from vimoclip_tpu.models.clip_vit import ClipVisionConfig as JConfig
from vimoclip_tpu.models.clip_vit import ClipVisionEncoder as JEncoder
from vimoclip_tpu_torch.cli import extract_embeddings, h5_merge
from vimoclip_tpu_torch.data.hdf5_schema import analyze_structure, compare_structures
from vimoclip_tpu_torch.models.clip_vit import ClipVisionConfig, ClipVisionEncoder
from vimoclip_tpu_torch.models.convert import clip_vision_state_from_jax, to_tensors
from vimoclip_tpu_torch.ops.preprocess import clip_preprocess

torch.set_num_threads(1)

GEOM = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=1,
            num_heads=2, intermediate_size=64, projection_dim=16)
CFG, JCFG = ClipVisionConfig(**GEOM), JConfig(**GEOM)
ATOL = 1e-4  # float32 embeddings: the two stacks sum in other orders
LENGTHS = {"v0.mp4": 5, "v1.mp4": 9, "v2.mp4": 3, "v3.mp4": 12}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(0)
    for vid, t in LENGTHS.items():
        jvr.write_video(str(root / vid), rng.integers(0, 256, (t, 36, 64, 3), dtype=np.uint8))
    (root / "train.txt").write_text(
        "v0.mp4 0 2\nv1.mp4 1\nv2.mp4 3\nv3.mp4 0 1 3\nmissing.mp4 2\n")
    (root / "classes.csv").write_text("id,name\n0,eat\n1,swim\n2,fly\n3,run\n")
    return str(root)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JEncoder(JCFG).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3), jnp.float32))["params"])


@pytest.fixture(scope="module")
def state(params):
    return clip_vision_state_from_jax(params, CFG, prefix="")


def _common(corpus, **kw):
    return dict(data_root=corpus, annotation_file=os.path.join(corpus, "train.txt"),
                class_file=os.path.join(corpus, "classes.csv"), batch_size=4,
                split="train", half_precision=False) | kw


def _ours(corpus, state, out, **kw):
    return ex.create_hdf5_dataset(output_hdf5=out, state=state, config=CFG, device="cpu",
                                  **_common(corpus, **kw))


def _jax(corpus, params, out, **kw):
    return jex.create_hdf5_dataset(output_hdf5=out, params=params, config=JCFG,
                                   **_common(corpus, **kw))


def _extractor(state, **kw):
    return ex.ClipExtractor(state, CFG, **({"batch_size": 4, "half_precision": False,
                                             "device": "cpu"} | kw))


def _collect(extractor, videos, **kw):
    got = {}
    errors = extractor.extract(videos, lambda vid, emb: got.__setitem__(vid, emb), **kw)
    return got, errors


def _sequential(state, frames):
    enc = ClipVisionEncoder(CFG)
    enc.load_state_dict(to_tensors(state))
    with torch.no_grad():
        return enc.eval()(clip_preprocess(torch.from_numpy(frames), 32)).numpy()


def _read(path):
    """{group: (attrs, embeddings, labels)}, file attrs, video_ids."""
    with h5py.File(path, "r") as f:
        groups = {k: (dict(g.attrs), g["embeddings"][:],
                      g["labels"][:] if "labels" in g else None)
                  for k, g in f.items() if isinstance(g, h5py.Group)}
        ids = list(f["video_ids"].asstr()[:]) if "video_ids" in f else None
        return groups, dict(f.attrs), ids


def _frame_rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


# int8 on both sides: the two stacks' quantiser inputs differ by ~5e-7
# relative (float32 sums in other orders), so a value within that of a
# rounding boundary takes the next code in one stack (seen once, 0.50007
# from the boundary, in a 2-layer tower); the flip moves that frame by a
# share of the int8 error itself (rel. L2 6.4e-3 there, against 1.0-1.1% of
# int8 vs exact). So a file may hold one such frame, moved by less than its
# own int8 error; every other frame agrees within INT8_REL, a thousandth of
# what int8 moves it. A flag that did nothing, reached one tower only or
# quantised otherwise would move every frame.
INT8_REL = 1e-5


def assert_int8_frames(ours, theirs, exact):
    """Per-frame embeddings ``{video: (frames, dim)}``: ours against JAX's
    int8 ones, with ``exact`` (no int8) giving int8's own effect."""
    flips = 0
    for vid, ref in theirs.items():
        effect = _frame_rel_l2(exact[vid], ref)
        assert effect.min() >= 100 * INT8_REL, (vid, effect)
        rel = _frame_rel_l2(ours[vid], ref)
        assert (rel < 0.75 * effect).all(), (vid, rel, effect)
        flips += int((rel > INT8_REL).sum())
    assert flips <= 1, flips


def assert_same_file(ours, theirs, exact=None):
    """Equal files; with ``exact``, ours and theirs are int8 files held by
    ``assert_int8_frames`` against that file without int8."""
    a, b = _read(ours), _read(theirs)
    assert sorted(a[0]) == sorted(b[0])
    assert a[1] == b[1] and a[2] == b[2]
    for vid, (attrs, emb, labels) in b[0].items():
        assert a[0][vid][0] == attrs
        np.testing.assert_array_equal(a[0][vid][2], labels)
        assert a[0][vid][1].shape == emb.shape
        if exact is None:
            np.testing.assert_allclose(a[0][vid][1], emb, atol=ATOL, rtol=0)
    if exact is not None:
        assert_int8_frames(*({vid: g[1] for vid, g in f[0].items()}
                             for f in (a, b, _read(exact))))
    for analyze, compare in ((analyze_structure, compare_structures),
                             (jax_analyze, jax_compare)):
        assert compare(analyze(ours), analyze(theirs)) == (True, [])


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_shard_annotations_is_the_strided_slice(corpus, num_shards):
    """What each shard extracts and probes: JAX's strided slice of the
    annotation list (``vimoclip_tpu/extraction.py``), the shards covering
    it once; an index outside [0, num_shards) raises."""
    ann = jex.load_annotations(os.path.join(corpus, "train.txt"))
    shards = [ex.shard_annotations(ann, num_shards, i) for i in range(num_shards)]
    assert shards == [ann[i::num_shards] for i in range(num_shards)]
    assert sorted(sum(shards, [])) == sorted(ann)
    with pytest.raises(ValueError, match="not in"):
        ex.shard_annotations(ann, num_shards, num_shards)


def test_annotation_and_class_parsing(corpus):
    ann = os.path.join(corpus, "train.txt")
    assert ex.load_annotations(ann) == jex.load_annotations(ann)
    assert ex.load_annotations(ann)[0] == ("v0.mp4", [0, 2])
    cls = os.path.join(corpus, "classes.csv")
    assert ex.load_class_map(cls) == jex.load_class_map(cls) == {
        0: "eat", 1: "swim", 2: "fly", 3: "run"}
    for labels in ([0, 2], [3], [], [1, 7]):
        np.testing.assert_array_equal(ex.multi_hot(labels, 4), jex.multi_hot(labels, 4))


@pytest.mark.parametrize("text", ["id,name\n0,eat\n1,swim\n", "0,eat\n1,swim\n"],
                         ids=["headered", "headerless"])
def test_load_class_names_matches_jax(tmp_path, text):
    path = tmp_path / "c.csv"
    path.write_text(text)
    assert ex.load_class_names(str(path)) == jex.load_class_names(str(path)) == {
        0: "eat", 1: "swim"}


@pytest.mark.parametrize("total, cap", [(10, None), (5, 10), (10, 3), (12, 4), (450, 50),
                                        (7, 7)])
def test_uniform_indices_matches_jax(total, cap):
    np.testing.assert_array_equal(ex.uniform_indices(total, cap),
                                  jex.uniform_indices(total, cap))


def test_extractor_matches_jax_and_sequential(corpus, params, state):
    videos = [(vid, os.path.join(corpus, vid)) for vid in LENGTHS]
    # a batch smaller than some videos packs frames across videos
    ours, errors = _collect(_extractor(state, decode_workers=2), videos)
    assert errors == {}
    theirs, errors = _collect(jex.ClipExtractor(params, JCFG, batch_size=4,
                                                half_precision=False, decode_workers=2),
                              videos)
    assert errors == {} and set(ours) == set(theirs) == set(LENGTHS)
    for vid, t in LENGTHS.items():
        assert ours[vid].shape == (t, 16) and ours[vid].dtype == np.float32
        np.testing.assert_allclose(ours[vid], theirs[vid], atol=ATOL, rtol=0)
        ref = _sequential(state, tvr.read_video(os.path.join(corpus, vid)))
        np.testing.assert_allclose(ours[vid], ref, atol=1e-5, rtol=0)


def test_extractor_error_tolerance(corpus, params, state, tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    videos = [("v0.mp4", os.path.join(corpus, "v0.mp4")), ("bad.mp4", str(bad)),
              ("v2.mp4", os.path.join(corpus, "v2.mp4"))]
    got, errors = _collect(_extractor(state, decode_workers=2), videos)
    theirs, jerrors = _collect(jex.ClipExtractor(params, JCFG, batch_size=4,
                                                 half_precision=False), videos)
    assert errors == jerrors and set(errors) == {"bad.mp4"}
    assert set(got) == set(theirs) == {"v0.mp4", "v2.mp4"}
    for vid in got:
        np.testing.assert_allclose(got[vid], theirs[vid], atol=ATOL, rtol=0)


def test_create_hdf5_dataset_matches_jax(corpus, params, state, tmp_path):
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    assert _ours(corpus, state, ours) == _jax(corpus, params, theirs) == {
        "missing.mp4": "not found"}
    assert_same_file(ours, theirs)
    groups, attrs, ids = _read(ours)
    assert attrs == {"num_classes": 4, "dataset_name": "AnimalKingdom", "type": "train",
                     "clip_model": "ViT-B/16"}
    assert ids == ["v0.mp4", "v1.mp4", "v2.mp4", "v3.mp4", "missing.mp4"]
    np.testing.assert_array_equal(groups["v3.mp4"][2], [1, 1, 0, 1])
    assert groups["v3.mp4"][0] == {"total_frames": 12, "original_frames": 12}


@pytest.mark.parametrize("lie", [False, True], ids=["honest", "under-reporting"])
def test_max_frames_matches_jax(corpus, params, state, tmp_path, monkeypatch, lie):
    """v3 has 12 frames: step 3 -> [0, 3, 6, 9]. A container claiming 3
    frames must still be capped afterwards (no streaming path)."""
    if lie:
        for mod in (jvr, tvr):
            real = mod.video_frame_count
            monkeypatch.setattr(mod, "video_frame_count",
                                lambda p, real=real: 3 if "v3" in p else real(p))
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    _ours(corpus, state, ours, max_frames=4, stream_rows=2)
    _jax(corpus, params, theirs, max_frames=4, stream_rows=2)
    assert_same_file(ours, theirs)
    groups = _read(ours)[0]
    assert groups["v3.mp4"][1].shape == (4, 16)
    assert groups["v3.mp4"][0]["total_frames"] == 4
    assert groups["v3.mp4"][0]["original_frames"] == (3 if lie else 12)
    assert groups["v0.mp4"][1].shape == (4, 16)
    full = _sequential(state, tvr.read_video(os.path.join(corpus, "v3.mp4")))
    np.testing.assert_allclose(groups["v3.mp4"][1], full[[0, 3, 6, 9]], atol=1e-5, rtol=0)


def test_extractor_mixed_resolutions(tmp_path, params, state):
    """Each resolution is preprocessed at its native size, in batches of its own."""
    rng = np.random.default_rng(4)
    videos = []
    for vid, (h, w) in {"a.mp4": (36, 64), "b.mp4": (48, 40), "c.mp4": (36, 64)}.items():
        path = str(tmp_path / vid)
        jvr.write_video(path, rng.integers(0, 256, (6, h, w, 3), dtype=np.uint8))
        videos.append((vid, path))
    ours, errors = _collect(_extractor(state, decode_workers=2), videos)
    assert errors == {}
    theirs, _ = _collect(jex.ClipExtractor(params, JCFG, batch_size=4, half_precision=False,
                                           decode_workers=2), videos)
    for vid, path in videos:
        np.testing.assert_allclose(ours[vid], theirs[vid], atol=ATOL, rtol=0)
        np.testing.assert_allclose(ours[vid], _sequential(state, tvr.read_video(path)),
                                   atol=1e-5, rtol=0)


def test_extractor_temporal_dedup_matches_jax(tmp_path, params, state):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (36, 64, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (36, 64, 3), dtype=np.uint8)
    path = str(tmp_path / "dup.mp4")
    jvr.write_video(path, np.stack([a, a, a, b, b, a]))
    videos = [("dup.mp4", path)]

    extractor = _extractor(state, decode_workers=1, dedup_threshold=2.0)
    calls = []
    embed = extractor._embed
    extractor._embed = lambda x: (calls.append(int(x.shape[0])), embed(x))[1]
    ours, errors = _collect(extractor, videos)
    assert errors == {}
    jextractor = jex.ClipExtractor(params, JCFG, batch_size=4, half_precision=False,
                                   decode_workers=1, dedup_threshold=2.0)
    jcalls = []
    jembed = jextractor._embed
    jextractor._embed = lambda p, x: (jcalls.append(int(x.shape[0])), jembed(p, x))[1]
    theirs, _ = _collect(jextractor, videos)
    emb = ours["dup.mp4"]
    assert emb.shape == (6, 16) and calls == jcalls == [4]
    # the same slot map: equal rows in the same places
    same = lambda e: [[bool(np.array_equal(e[i], e[j])) for j in range(6)] for i in range(6)]
    assert same(emb) == same(theirs["dup.mp4"])
    np.testing.assert_array_equal(emb[0], emb[2])
    np.testing.assert_array_equal(emb[3], emb[4])
    assert not np.allclose(emb[0], emb[3])
    np.testing.assert_allclose(emb, theirs["dup.mp4"], atol=ATOL, rtol=0)
    full, _ = _collect(_extractor(state, decode_workers=1), videos)
    np.testing.assert_allclose(emb[0], full["dup.mp4"][0], atol=1e-6, rtol=0)


def test_extractor_streaming_equals_whole(corpus, params, state):
    videos = [(vid, os.path.join(corpus, vid)) for vid in LENGTHS]
    batch, stream_rows = 4, 4
    chunks: dict[str, list] = {}
    finals, errors = _collect(
        _extractor(state, decode_workers=2), videos,
        on_video_chunk=lambda vid, c: chunks.setdefault(vid, []).append(c),
        stream_rows=stream_rows)
    assert errors == {} and set(finals) == set(LENGTHS)
    whole, _ = _collect(jex.ClipExtractor(params, JCFG, batch_size=batch,
                                          half_precision=False), videos)
    for vid, t in LENGTHS.items():
        parts = chunks.get(vid, [])
        assert all(len(c) < stream_rows + batch for c in parts)
        if finals[vid] is None:  # streamed: the chunks are the whole video
            assert t >= stream_rows
            got = np.concatenate(parts)
        else:
            assert parts == []
            got = finals[vid]
        assert got.shape == (t, 16)
        np.testing.assert_allclose(got, whole[vid], atol=ATOL, rtol=0)


def test_create_hdf5_dataset_streaming_matches_jax_whole(corpus, params, state, tmp_path):
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    _ours(corpus, state, ours, stream_rows=4)
    _jax(corpus, params, theirs)
    assert_same_file(ours, theirs)


def test_streaming_abort_rolls_back_partial_video(corpus, params, state, tmp_path,
                                                  monkeypatch):
    """v3 fails mid-decode after streaming chunks: no group, still indexed."""
    def flaky(real):
        def it(path, chunk_size):
            if "v3" in path:
                chunks = real(path, chunk_size=4)
                yield next(chunks)
                yield next(chunks)
                raise IOError("synthetic mid-decode failure")
            yield from real(path, chunk_size=chunk_size)
        return it

    monkeypatch.setattr(ex, "iter_video_chunks", flaky(tvr.iter_video_chunks))
    monkeypatch.setattr(jex, "iter_video_chunks", flaky(jvr.iter_video_chunks))
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    errors = _ours(corpus, state, ours, stream_rows=4)
    assert errors == _jax(corpus, params, theirs, stream_rows=4)
    assert set(errors) == {"v3.mp4", "missing.mp4"}
    assert_same_file(ours, theirs)
    groups, _, ids = _read(ours)
    assert set(groups) == {"v0.mp4", "v1.mp4", "v2.mp4"} and "v3.mp4" in ids


@pytest.mark.parametrize("n_shards", [2, 6], ids=["two", "with-empty-shard"])
def test_sharded_extraction_and_merge_match_jax(corpus, params, state, tmp_path, n_shards):
    whole = str(tmp_path / "whole.h5")
    _ours(corpus, state, whole)
    ours, theirs = [], []
    for i in range(n_shards):
        ours.append(str(tmp_path / f"s{i}.h5"))
        theirs.append(str(tmp_path / f"j{i}.h5"))
        _ours(corpus, state, ours[-1], num_shards=n_shards, shard_index=i)
        _jax(corpus, params, theirs[-1], num_shards=n_shards, shard_index=i)
        assert_same_file(ours[-1], theirs[-1])
    merged, jmerged = str(tmp_path / "merged.h5"), str(tmp_path / "jmerged.h5")
    assert h5_merge.main(ours + ["--output", merged]) == 0
    assert jax_merge(theirs, jmerged) == h5_merge.merge(ours, str(tmp_path / "m2.h5"))
    assert_same_file(merged, jmerged)
    assert_same_file(merged, whole)
    assert h5_merge.main([ours[0], ours[0], "--output", str(tmp_path / "dup.h5")]) == 1
    with pytest.raises(ValueError, match="duplicate"):
        h5_merge.merge([ours[0], ours[0]], str(tmp_path / "dup.h5"))
    with pytest.raises(ValueError, match="shard_index"):
        _ours(corpus, state, str(tmp_path / "bad.h5"), num_shards=2, shard_index=2)


def test_float32_flag_reaches_the_extractor(corpus, state, tmp_path, monkeypatch):
    seen = {}
    real = ex.ClipExtractor

    class Spy(real):
        def __init__(self, *a, **kw):
            seen["half_precision"] = kw.get("half_precision")
            super().__init__(*a, **kw)

    monkeypatch.setattr(ex, "ClipExtractor", Spy)
    _ours(corpus, state, str(tmp_path / "f32.h5"))
    assert seen["half_precision"] is False
    extract_embeddings.main([
        "--data-root", corpus, "--annotation-file", os.path.join(corpus, "train.txt"),
        "--class-file", os.path.join(corpus, "classes.csv"),
        "--output", str(tmp_path / "bf16.h5"), "--clip-weights", _hf_checkpoint(tmp_path),
        "--device", "cpu"])
    assert seen["half_precision"] is True
    assert _read(str(tmp_path / "bf16.h5"))[0]["v0.mp4"][1].dtype == np.float32


def _hf_checkpoint(tmp_path, layers=1):
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModelWithProjection

    path = tmp_path / ("clip.pt" if layers == 1 else f"clip{layers}.pt")
    if not path.exists():
        torch.manual_seed(1)
        hf = CLIPVisionModelWithProjection(HFConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=layers,
            num_attention_heads=4, image_size=32, patch_size=8, projection_dim=16))
        torch.save(hf.state_dict(), path)
    return str(path)


def test_extract_embeddings_cli_matches_jax(corpus, tmp_path):
    ckpt = _hf_checkpoint(tmp_path)
    common = ["--data-root", corpus, "--annotation-file", os.path.join(corpus, "train.txt"),
              "--class-file", os.path.join(corpus, "classes.csv"), "--clip-weights", ckpt,
              "--batch-size", "8", "--split", "train", "--float32", "--max-frames", "6"]
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    extract_embeddings.main(common + ["--output", ours, "--device", "cpu"])
    jax_cli(common + ["--output", theirs])
    assert_same_file(ours, theirs)
    assert _read(ours)[0]["v3.mp4"][1].shape == (6, 16)


@pytest.mark.parametrize("extra", [["--quantize", "int8"], ["--token-merge", "4"],
                                   ["--quantize", "int8", "--verify-fidelity", "3"],
                                   ["--token-merge", "4", "--verify-fidelity", "3",
                                    "--fidelity-threshold", "1.0"]],
                         ids=["quantize", "token-merge", "verify-fidelity",
                              "fidelity-threshold"])
def test_cli_accelerator_flags_match_jax(corpus, tmp_path, extra):
    """Each opt-in flag against the JAX CLI on the same corpus and a 2-layer
    checkpoint (17 tokens, 4 merged after the first block): equal files, or
    both stopping with FidelityError before any file is written."""
    from vimoclip_tpu.fidelity import FidelityError as JFidelityError
    from vimoclip_tpu_torch.fidelity import FidelityError

    base = ["--data-root", corpus, "--annotation-file", os.path.join(corpus, "train.txt"),
            "--class-file", os.path.join(corpus, "classes.csv"),
            "--clip-weights", _hf_checkpoint(tmp_path, layers=2), "--batch-size", "8",
            "--split", "train", "--float32", "--max-frames", "6"]
    common = base + extra
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "jax.h5")
    if "1.0" in extra:
        with pytest.raises(FidelityError):
            extract_embeddings.main(common + ["--output", ours, "--device", "cpu"])
        with pytest.raises(JFidelityError):
            jax_cli(common + ["--output", theirs])
        assert not os.path.exists(ours) and not os.path.exists(theirs)
        return
    extract_embeddings.main(common + ["--output", ours, "--device", "cpu"])
    jax_cli(common + ["--output", theirs])
    exact = str(tmp_path / "exact.h5")
    extract_embeddings.main(base + ["--output", exact, "--device", "cpu"])
    assert_same_file(ours, theirs, exact if "--quantize" in extra else None)
    assert not np.allclose(_read(ours)[0]["v3.mp4"][1], _read(exact)[0]["v3.mp4"][1],
                           atol=ATOL)


@pytest.mark.parametrize("extra", [["--data-parallel", "2"]], ids=["data-parallel"])
def test_cli_refuses_later_slices(corpus, tmp_path, extra):
    with pytest.raises(SystemExit):
        extract_embeddings.main([
            "--data-root", corpus, "--annotation-file", os.path.join(corpus, "train.txt"),
            "--class-file", os.path.join(corpus, "classes.csv"),
            "--output", str(tmp_path / "x.h5"), "--clip-weights", "none",
            "--device", "cpu"] + extra)
    assert not (tmp_path / "x.h5").exists()


def test_mesh_is_refused(state):
    with pytest.raises(NotImplementedError, match="slice 7"):
        ex.ClipExtractor(state, CFG, mesh=object(), device="cpu")

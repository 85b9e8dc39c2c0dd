"""Merge sharded embedding HDF5 files into one reference-layout file (the
port's copy of ``vimoclip_tpu/cli/h5_merge.py``).

    python -m vimoclip_tpu_torch.cli.h5_merge shard0.h5 shard1.h5 --output all.h5

The companion of ``vimo-extract-embeddings-torch --num-shards/--shard-index``
(one writer per HDF5 file, so each job writes its own). Groups are copied as
they are (datasets, attrs, nesting: the AK flat and MN ``trimmed_videos/``
layouts); file attrs come from the first shard; the top-level ``video_ids``
interleaves the shards' indexes, which restores the annotation order of one
unsharded run (extract_embeddings.py:118-119). Exit code 0, or 1 when two
shards hold the same group. Host-only: no device work.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np


def _interleave(per_shard: list[list[str]]) -> list[str]:
    """Undo the extractor's strided split: shard i holds
    ``annotations[i::n]``, so round-robin across shards restores the
    annotation order (uneven tails included)."""
    out: list[str] = []
    for row in itertools.zip_longest(*per_shard):
        out.extend(x for x in row if x is not None)
    return out


def merge(shard_paths: list[str], output: str) -> dict[str, int]:
    """Merge ``shard_paths`` (in shard-index order) into ``output``; returns
    counts. Raises ValueError on a duplicate group key (overlapping shards)."""
    import h5py

    per_shard_ids: list[list[str]] = []
    with h5py.File(output, "w") as out:
        for i, path in enumerate(shard_paths):
            with h5py.File(path, "r") as f:
                if i == 0:
                    for k, v in f.attrs.items():
                        out.attrs[k] = v
                # a shard with no video_ids (more shards than annotations)
                # still takes its round-robin slot, or the order shifts
                per_shard_ids.append(
                    list(f["video_ids"].asstr()[:]) if "video_ids" in f else []
                )
                for key in f.keys():
                    if key == "video_ids":
                        continue
                    if isinstance(f[key], h5py.Group) and key in out:
                        # nested layout (trimmed_videos/): merge the children
                        for sub in f[key].keys():
                            if sub in out[key]:
                                raise ValueError(
                                    f"duplicate group {key}/{sub} in {path}"
                                )
                            f.copy(f[key][sub], out[key], name=sub)
                        continue
                    if key in out:
                        raise ValueError(f"duplicate group {key} in {path}")
                    f.copy(f[key], out, name=key)
        all_ids = _interleave(per_shard_ids)
        if all_ids:
            out.create_dataset(
                "video_ids", data=np.array(all_ids, dtype=h5py.string_dtype())
            )
        # a group is a video iff it holds 'embeddings'; containers such as
        # trimmed_videos/ are walked one level
        n_groups = 0
        for key, node in out.items():
            if not isinstance(node, h5py.Group):
                continue
            if "embeddings" in node:
                n_groups += 1
            else:
                n_groups += sum(
                    1 for sub in node.values()
                    if isinstance(sub, h5py.Group) and "embeddings" in sub
                )
        stats = {"groups": n_groups, "video_ids": len(all_ids)}
    return stats


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Merge sharded embedding HDF5 files into one (PyTorch/CUDA port)"
    )
    p.add_argument("shards", nargs="+", help="shard files, in shard order")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    try:
        stats = merge(args.shards, args.output)
    except ValueError as e:
        print(f"merge failed: {e}", file=sys.stderr)
        return 1
    print(
        f"merged {len(args.shards)} shards -> {args.output}: "
        f"{stats['groups']} video groups, {stats['video_ids']} indexed ids"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Check that two embedding HDF5 files share one structure (the port's copy
of ``vimoclip_tpu/cli/h5_structure_checker.py``; the reference's
``utils/h5_structure_checker.py``).

    python -m vimoclip_tpu_torch.cli.h5_structure_checker a.h5 b.h5 [--json]

Exit code 0 when the structures match, 1 when they do not. Host-only: no
device work.
"""

from __future__ import annotations

import argparse
import json
import sys

from vimoclip_tpu_torch.data.hdf5_schema import analyze_structure, compare_structures


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Compare HDF5 embedding structures "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("file1")
    parser.add_argument("file2")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    a = analyze_structure(args.file1)
    b = analyze_structure(args.file2)
    ok, issues = compare_structures(a, b)

    if args.json:
        print(json.dumps({"match": ok, "issues": issues, "a": a, "b": b}, indent=2))
    else:
        for s in (a, b):
            print(f"{s['path']}: {s['num_groups']} groups, "
                  f"root datasets {s['root_dataset_names']}, "
                  f"consistent={s['all_groups_same_structure']}")
        if ok:
            print("STRUCTURES MATCH")
        else:
            print("STRUCTURES DO NOT MATCH:")
            for issue in issues:
                print(f"  - {issue}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

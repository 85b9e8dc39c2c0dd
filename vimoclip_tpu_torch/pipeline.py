"""One-command orchestration of the whole cascade (the port's copy of
``vimoclip_tpu/pipeline.py``).

The reference ships the cascade as five scripts chained by hand (README:
extract_embeddings.py -> generate_*_videos.py -> train*.py -> inference*.py
-> TFAM/train_and_eval*.py). ``run_pipeline`` drives the same chain through
the port's own CLIs, with one artifact layout under ``workdir`` and stages
that skip once done; ``vimo-pipeline-torch`` is its command line.

Resume: a stage writes its ``.<stage>.done`` marker only after it succeeded,
and the skip checks the marker, never the artifact alone (a crash can leave
a plausible partial HDF5 or checkpoint). Rerunning the same command after a
crash skips the finished stages and reruns the interrupted one; stage 1
gets ``--resume`` (training continues from its latest checkpoint) and the
motion export resumes group by group. ``force=True`` ignores the markers
and passes the overwrite flags on.

Every stage runs on ``device`` (default ``cuda``; an error without a card).
With ``cpu``, stages 0, 1 and 1b get ``--device cpu`` and the injected
stage-2 YAML ``training.device: cpu``, the only way the stage-2 CLI takes
the CPU.

Data and tensor parallelism, as in JAX: ``data_parallel`` > 1 gives stage 0
that many replicas of the tower; stage 1 trains on ``data_parallel`` x
``model_parallel`` ranks (-1: every card, one rank on the CPU) and stage 2
on its YAML's ``training.data_parallel`` x ``model_parallel`` x
``parallelism.seq`` x ``parallelism.pipe``. A training
stage with more than one rank runs as
``torchrun --standalone --nproc-per-node N -m <its CLI>``, one process per
rank; with one it runs in this process.

A workdir of the port is not one of the JAX package: the stage-1
checkpoints differ (``student_ckpt/best/best_model.pth`` here, Orbax
directories there), so neither package resumes the other's run.

Artifact layout under ``workdir``:

    rgb_train.h5, rgb_val.h5     stage-0 teacher embeddings
    motion_videos/               generated motion modality
    student_ckpt/                stage-1 checkpoints
    motion.h5                    stage-1 exported motion embeddings
    tfam/pipeline.yaml           stage-2 config with data paths injected
    tfam/pipeline/{logs,checkpoints}/<run>  stage-2 run dirs
    tfam/results/results_*.json  stage-2 evaluation output
    .<stage>.done                per-stage completion markers

PyYAML is imported by stage 2 only.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import subprocess
import sys

import torch

from vimoclip_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    workdir: str
    data_root: str
    train_annotations: str
    val_annotations: str
    class_file: str
    clip_weights: str
    tfam_config: str
    dataset: str = "ak"  # ak | mammalnet (CE loss + nested groups in stage 1;
    # MN stage 2 also needs training.loss: ce in the TFAM YAML)
    motion_kind: str = "frame_diff"  # frame_diff | flow
    flow_backend: str = "farneback"
    flow_weights: str | None = None
    num_classes: int = 140
    extract_batch: int = 256
    student_epochs: int = 10
    student_batch: int = 8
    sequence_length: int = 30
    num_workers: int = 4
    half_precision: bool = True
    data_parallel: int = -1  # stage-1 data axis (-1: every card); stage-0 replicas
    model_parallel: int = 1
    force: bool = False  # rerun stages even when their markers exist
    device: str = "cuda"


def world_size(data_parallel: int, model_parallel: int, device: torch.device,
               seq: int = 1, pipe: int = 1) -> int:
    """The ranks a training stage runs on: data x model x seq x pipe, where
    data -1 takes every card left (one data rank on the CPU)."""
    rest = model_parallel * max(1, seq) * max(1, pipe)
    data = data_parallel
    if data == -1:
        data = torch.cuda.device_count() // rest if device.type == "cuda" else 1
    return max(1, data) * rest


def run_stage(main, module: str, argv: list[str], world: int, cwd: str | None = None):
    """A CLI's ``main(argv)`` in this process for one rank; for more,
    ``torchrun`` starts one process per rank (the package importable from
    where it lies) and a failed rank fails the stage."""
    if world <= 1:
        if cwd is None:
            return main(argv)
        old = os.getcwd()
        try:
            os.chdir(cwd)
            return main(argv)
        finally:
            os.chdir(old)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", "-m", module, *argv]
    logging.info("[pipeline] %s", " ".join(cmd))
    subprocess.run(cmd, check=True, cwd=cwd, env=env)


def run_pipeline(cfg: PipelineConfig) -> dict:
    """Run (or resume) the whole cascade; returns the artifact paths."""
    device = resolve_device(cfg.device)
    # every path absolute: stage 2 runs chdir'd into its run dir, and a
    # relative workdir must survive that
    cfg = dataclasses.replace(
        cfg,
        workdir=os.path.abspath(cfg.workdir),
        data_root=os.path.abspath(cfg.data_root),
        train_annotations=os.path.abspath(cfg.train_annotations),
        val_annotations=os.path.abspath(cfg.val_annotations),
        class_file=os.path.abspath(cfg.class_file),
        clip_weights=os.path.abspath(cfg.clip_weights),
        tfam_config=os.path.abspath(cfg.tfam_config),
    )
    os.makedirs(cfg.workdir, exist_ok=True)
    w = lambda name: os.path.join(cfg.workdir, name)
    float32 = ["--float32"] if not cfg.half_precision else []
    on_device = [] if cfg.device == "cuda" else ["--device", cfg.device]

    def marker(stage: str) -> str:
        return w(f".{stage}.done")

    def is_done(stage: str) -> bool:
        if not cfg.force and os.path.exists(marker(stage)):
            logging.info("[pipeline] %s: done marker exists, skipping", stage)
            return True
        logging.info("[pipeline] running %s", stage)
        return False

    def mark_done(stage: str) -> None:
        with open(marker(stage), "w"):
            pass

    # stage 0: teacher extraction (train and val splits)
    from vimoclip_tpu_torch.cli.extract_embeddings import main as extract_main

    common = [
        "--data-root", cfg.data_root, "--class-file", cfg.class_file,
        "--clip-weights", cfg.clip_weights,
        "--batch-size", str(cfg.extract_batch),
    ] + float32 + on_device
    if cfg.data_parallel > 1:
        common += ["--data-parallel", str(cfg.data_parallel)]
    rgb_train = w("rgb_train.h5")
    if not is_done("extract_train"):
        extract_main(["--annotation-file", cfg.train_annotations,
                      "--output", rgb_train, "--split", "train"] + common)
        mark_done("extract_train")
    rgb_val = w("rgb_val.h5")
    if not is_done("extract_val"):
        extract_main(["--annotation-file", cfg.val_annotations,
                      "--output", rgb_val, "--split", "val"] + common)
        mark_done("extract_val")

    # stage 0b: motion videos for every annotated video, through the library
    # call and not the CLI: its errors gate the marker, since an incomplete
    # motion corpus would poison every later stage
    from vimoclip_tpu_torch.extraction import load_annotations
    from vimoclip_tpu_torch.motion import load_flow_backend, process_video_list

    motion_dir = w("motion_videos")
    if not is_done("generate_motion"):
        names: list[str] = []
        seen = set()
        for ann in (cfg.train_annotations, cfg.val_annotations):
            for name, _ in load_annotations(ann):
                if name not in seen:
                    seen.add(name)
                    names.append(name)
        list_file = w("video_list.txt")
        with open(list_file, "w") as f:
            f.write("\n".join(names))
        flow_fn = None
        if cfg.motion_kind == "flow" and cfg.flow_backend != "farneback":
            flow_fn = load_flow_backend(cfg.flow_backend, weights=cfg.flow_weights,
                                        device=device)
        errors = process_video_list(
            list_file, cfg.data_root, motion_dir, kind=cfg.motion_kind,
            skip_existing=not cfg.force, flow_fn=flow_fn, device=device,
        )
        if errors:
            raise RuntimeError(
                f"motion generation failed for {len(errors)} videos "
                f"(e.g. {next(iter(errors.items()))}); fix the corpus or "
                "remove them from the annotations, then rerun"
            )
        mark_done("generate_motion")
    # motion generation keeps the corpus layout; the reference's MN datasets
    # read motion clips from a flat dir keyed by bare video id
    # (dataset_frame_diff_mn.py:116), so stages 1/1b read the nested subdir
    stage1_motion_dir = (
        os.path.join(motion_dir, "trimmed_videos")
        if cfg.dataset == "mammalnet" else motion_dir
    )

    # stage 1: student distillation (--resume continues a crashed run from
    # its latest checkpoint; the marker lands once every epoch is done)
    from vimoclip_tpu_torch.cli.train_student import main as train_main

    student_ckpt = w("student_ckpt")
    if not is_done("train_student"):
        run_stage(train_main, "vimoclip_tpu_torch.cli.train_student", [
            "--train-embeddings", rgb_train, "--val-embeddings", rgb_val,
            "--motion-videos-dir", stage1_motion_dir,
            "--checkpoint-dir", student_ckpt, "--log-dir", w("student_logs"),
            "--clip-weights", cfg.clip_weights,
            "--epochs", str(cfg.student_epochs),
            "--batch-size", str(cfg.student_batch),
            "--num-workers", str(cfg.num_workers),
            "--sequence-length", str(cfg.sequence_length),
            "--num-classes", str(cfg.num_classes), "--resume",
            "--data-parallel", str(cfg.data_parallel),
            "--model-parallel", str(cfg.model_parallel),
            "--dataset", cfg.dataset,
        ] + float32 + on_device,
            world_size(cfg.data_parallel, cfg.model_parallel, device))
        mark_done("train_student")

    # stage 1b: motion-embedding export (the exporter resumes a partial
    # motion.h5 group by group; force overwrites it)
    from vimoclip_tpu_torch.cli.export_motion_embeddings import main as export_main

    motion_h5 = w("motion.h5")
    if not is_done("export_motion"):
        export_main([
            "--videos-dir", stage1_motion_dir, "--output", motion_h5,
            "--checkpoint-dir", student_ckpt,
            "--clip-weights", cfg.clip_weights,
        ] + float32 + on_device + (["--overwrite"] if cfg.force else []))
        mark_done("export_motion")

    # schema gate (the reference's de-facto integration check): the train
    # and val teacher files share one structure
    from vimoclip_tpu_torch.cli.h5_structure_checker import main as checker_main

    if checker_main([rgb_train, rgb_val]) != 0:
        raise RuntimeError("train/val teacher HDF5 schemas diverge")

    # stage 2: TFAM train + eval on the user's stage-2 config with the data
    # paths injected. The injected config lives inside tfam/, so the run
    # dirs derived from its name land under tfam/pipeline/.
    import yaml

    from vimoclip_tpu_torch.cli.tfam_train_eval import main as tfam_main
    from vimoclip_tpu_torch.config import load_experiment_config

    with open(cfg.tfam_config) as f:
        tfam_cfg = yaml.safe_load(f) or {}
    data = tfam_cfg.setdefault("data", {})
    # stage 2 runs chdir'd into tfam/: every relative path-like value is
    # taken relative to the YAML's own directory
    yaml_dir = os.path.dirname(cfg.tfam_config)
    for key, val in list(data.items()):
        if (key.endswith(("_path", "_dir", "_file")) and isinstance(val, str)
                and not os.path.isabs(val)):
            data[key] = os.path.abspath(os.path.join(yaml_dir, val))
    data["train_dataset_path"] = rgb_train
    data["val_dataset_path"] = rgb_val
    data["flow_dataset_path"] = motion_h5
    data.setdefault("class_names_dir", cfg.class_file)
    data.setdefault("num_classes", cfg.num_classes)
    tfam_args = []
    if device.type == "cpu":
        tfam_cfg.setdefault("training", {})["device"] = "cpu"
    elif cfg.device != "cuda":
        tfam_args = ["--device", cfg.device]
    rundir = w("tfam")
    os.makedirs(rundir, exist_ok=True)
    injected = os.path.join(rundir, "pipeline.yaml")
    with open(injected, "w") as f:
        yaml.safe_dump(tfam_cfg, f)
    if not is_done("tfam"):
        tcfg = load_experiment_config(injected).training
        run_stage(tfam_main, "vimoclip_tpu_torch.cli.tfam_train_eval",
                  ["--config", injected, "--run-name", "pipeline"] + tfam_args,
                  world_size(tcfg.data_parallel, tcfg.model_parallel, device,
                             tcfg.seq_parallel, tcfg.pipeline_parallel),
                  cwd=rundir)  # results/ lands here
        mark_done("tfam")

    return {
        "rgb_train": rgb_train, "rgb_val": rgb_val,
        "motion_videos": motion_dir, "student_ckpt": student_ckpt,
        "motion_embeddings": motion_h5, "tfam_config": injected,
        "tfam_rundir": rundir,
        "tfam_results": sorted(
            glob.glob(os.path.join(rundir, "results", "results_*.json"))
        ),
    }

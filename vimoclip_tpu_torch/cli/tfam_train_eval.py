"""Stage-2 CLI: train and/or evaluate TFAM from a YAML config (the port's
copy of ``vimoclip_tpu/cli/tfam_train_eval.py``; the reference's
``python TFAM/train_and_eval.py --config cfg.yaml``).

    python -m vimoclip_tpu_torch.cli.tfam_train_eval --config cfg.yaml

It trains on the card (``--device``, default ``cuda``) and raises when there
is none; ``training.device: cpu`` in the config is the only way onto the
CPU. ``training.mode`` picks train, test or both; ``training.loss: ce`` /
``training.metric: accuracy`` give the MammalNet variant.

On N cards, one process per card under ``torchrun``, with
``training.data_parallel`` x ``model_parallel`` x ``parallelism.seq`` x
``parallelism.pipe`` = N (``data_parallel: -1`` takes every rank left)::

    torchrun --nproc-per-node N -m vimoclip_tpu_torch.cli.tfam_train_eval --config cfg.yaml

A geometry that does not match the ranks is refused with the command to
run.
"""

from __future__ import annotations

import argparse
import logging

from vimoclip_tpu_torch.config import derive_run_dirs, load_experiment_config
from vimoclip_tpu_torch.parallel.mesh import initialize_distributed
from vimoclip_tpu_torch.prng import set_seed
from vimoclip_tpu_torch.train.tfam_trainer import TFAMTester, TFAMTrainer
from vimoclip_tpu_torch.utils.logging import setup_logging


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Train and/or evaluate TFAM "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("--config", type=str, default="config_default.yaml",
                        help="path to YAML config")
    parser.add_argument("--run-name", type=str, default=None,
                        help="run directory name (default: timestamp)")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="evaluate a reference-format best_model.pth instead "
                             "of this run's best checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the card to train on (cuda, cuda:N); the CPU only "
                             "through training.device: cpu in the config")
    parser.add_argument("--results-dir", type=str, default="results")
    args = parser.parse_args(argv)
    if not args.device.startswith("cuda"):
        parser.error("--device names a card (cuda or cuda:N); set training.device: "
                     "cpu in the config to run on the CPU")

    config = load_experiment_config(args.config)
    if config.training.device != "cpu":
        config.training.device = args.device
    set_seed(config.training.seed)
    setup_logging()
    run_name = args.run_name
    if initialize_distributed(config.training.device) and run_name is None:
        import torch.distributed as dist
        from datetime import datetime

        # one timestamp for every rank: rank 0's
        names = [datetime.now().strftime("%Y%m%d-%H%M%S")]
        dist.broadcast_object_list(names, src=0)
        run_name = names[0]
    log_dir, ckpt_dir = derive_run_dirs(config, run_name)
    logging.info("run dirs: logs=%s checkpoints=%s", log_dir, ckpt_dir)

    trainer = TFAMTrainer(config, log_dir=log_dir, checkpoint_dir=ckpt_dir)
    if config.training.mode in ("train", "both"):
        trainer.train()
    if config.training.mode in ("test", "both"):
        tester = TFAMTester(trainer, results_dir=args.results_dir)
        if args.torch_checkpoint:
            tester.load_torch_checkpoint(args.torch_checkpoint)
        else:
            tester.load_best()
        tester.evaluate(save_predictions=True, top_k=5)


if __name__ == "__main__":
    main()

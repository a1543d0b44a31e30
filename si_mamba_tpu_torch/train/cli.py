"""CLI entry: ``python -m si_mamba_tpu_torch.train.cli --config <yaml> [...]``,
run from the repository root (the configs' ``_base_`` refs and the
``experiments/`` tree are relative to the working directory).

The counterpart of ``si_mamba_tpu/train/cli.py`` (the reference's
main.py / utils/parser.py): the same flags (--test, --vote, --resume,
--auto_resume, --ckpts, --finetune_model, --scratch_model, few-shot
--way/--shot/--fold), experiment directory and config snapshot, plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU). The finetune and
test paths of the ``PointMamba`` classifier, MAE pretraining (``NAME:
Point_MAE_Mamba``: ShapeNet-55 to train, the SVM probe on ModelNet40's h5
shards) and the part-segmentation trainer (``NAME: PartSegModel``, on a
ShapeNetPart tree at ``data_root``) run; --tsne (M21) raises with its
ROADMAP.md item.
Checkpoints are reference-format ``.pth`` files (``train/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from si_mamba_tpu_torch.data.datasets import build_dataset
from si_mamba_tpu_torch.data.loader import Loader
from si_mamba_tpu_torch.train import runner_finetune as rf
from si_mamba_tpu_torch.train.checkpoint import check_pth
from si_mamba_tpu_torch.train.config import ConfigDict, get_config, save_experiment_config
from si_mamba_tpu_torch.train.logging_utils import get_logger, print_log
from si_mamba_tpu_torch.train.registry import build_model_from_cfg
from si_mamba_tpu_torch.utils.device import resolve_device
from si_mamba_tpu_torch.utils.weights import load_state_dict_file


def get_args(argv=None):
    p = argparse.ArgumentParser("si-mamba-tpu-torch")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--exp_name", type=str, default="default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--tsne", action="store_true",
                   help="t-SNE scatter of test-set features (not ported: ROADMAP.md M21)")
    p.add_argument("--vote", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the experiment's ckpt-last.pth when one exists, "
                        "start fresh otherwise (a preempted job's relaunch)")
    p.add_argument("--ckpts", type=str, default=None, help="a .pth to test (with --test)")
    p.add_argument("--finetune_model", type=str, default=None,
                   help="pretrained weights to finetune from (a .pth)")
    p.add_argument("--scratch_model", action="store_true")
    p.add_argument("--way", type=int, default=-1)
    p.add_argument("--shot", type=int, default=-1)
    p.add_argument("--fold", type=int, default=-1)
    p.add_argument("--val_freq", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.test and args.resume:
        raise ValueError("--test and --resume cannot be both activated")
    stem = os.path.splitext(os.path.basename(args.config))[0]
    args.experiment_path = os.path.join("experiments", stem, args.exp_name)
    os.makedirs(args.experiment_path, exist_ok=True)
    return args


def _dataset_kwargs(dcfg: ConfigDict, args, subset: str) -> tuple[str, dict]:
    """The JAX CLI's mapping of a dataset entry to its constructor's
    arguments, and ``--seed`` for the datasets that draw a sample's points
    (ShapeNet-55, ModelNet's and ScanObjectNN's train splits): their draws then repeat run to run
    at ``--num_workers 1``. With more workers the threads take the draws in
    the order they run (ROADMAP.md M12c)."""
    base = dcfg["_base_"]
    others = dcfg.get("others", ConfigDict())
    name = base["NAME"]
    npoints = others.get("npoints")
    if name == "ShapeNet":
        return name, dict(data_path=base["DATA_PATH"], pc_path=base["PC_PATH"],
                          subset=others.get("subset", subset),
                          npoints=npoints or base.get("N_POINTS", 1024),
                          whole=bool(others.get("whole", subset == "train")), seed=args.seed)
    if name == "ModelNet":
        return name, dict(data_path=base["DATA_PATH"],
                          subset=others.get("subset", subset),
                          npoints=base.get("N_POINTS", 8192),
                          num_category=base.get("NUM_CATEGORY", 40),
                          use_normals=bool(base.get("USE_NORMALS", False)), seed=args.seed)
    if name == "ModelNet40SVM":
        return name, dict(data_path=base["DATA_PATH"],
                          partition=others.get("partition", subset),
                          num_points=others.get("num_points", 2048))
    if name in ("ScanObjectNN", "ScanObjectNN_hardest"):
        return name, dict(root=base["ROOT"], subset=others.get("subset", subset),
                          seed=args.seed)
    if name == "ModelNetFewShot":
        return name, dict(data_path=base["DATA_PATH"],
                          subset=others.get("subset", subset),
                          way=args.way, shot=args.shot, fold=args.fold)
    raise KeyError(name)


def build_loader(dcfg, args, subset: str, batch_size: int, shuffle: bool,
                 drop_last: bool) -> Loader:
    """The loader of one dataset entry of the config. A ModelNet cache that
    is missing is built with FPS on ``args.device``."""
    name, kwargs = _dataset_kwargs(dcfg, args, subset)
    if name == "ModelNet":
        kwargs["device"] = args.device
    # one process: its loader takes every sample (data parallelism is M18b)
    return Loader(build_dataset(name, **kwargs), batch_size=batch_size, shuffle=shuffle,
                  drop_last=drop_last, seed=args.seed,
                  prefetch=max(int(args.num_workers), 0),
                  num_workers=max(int(args.num_workers), 1))


def _archive_source(exp_dir: str) -> None:
    """Snapshot the package source into the experiment dir (reference
    ``archive_project_files_tar``, main.py:17-31)."""
    import tarfile

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = os.path.join(exp_dir, "source_snapshot.tar.gz")
    try:
        with tarfile.open(out, "w:gz") as tar:
            tar.add(pkg_root, arcname="si_mamba_tpu_torch",
                    filter=lambda ti: None if ti.name.endswith((".so", ".pyc")) else ti)
    except OSError:
        pass


def _load_pretrained(path: str) -> dict:
    """A reference-format ``.pth``'s weights as a flat state dict; an orbax
    directory raises with the command that converts it."""
    check_pth(path)
    if not path.endswith(".pth"):
        raise ValueError(f"{path}: expected a .pth checkpoint")
    return load_state_dict_file(path)


def _should_auto_resume(args, snapshot: str) -> bool:
    """With --auto_resume a relaunched job resumes from the experiment's
    ckpt-last.pth (and its config snapshot) when one exists and starts fresh
    otherwise; --test and --resume are left alone."""
    return (getattr(args, "auto_resume", False) and not args.test
            and not args.resume
            and os.path.exists(os.path.join(args.experiment_path, "ckpt-last.pth"))
            and os.path.exists(snapshot))


def _part_seg(config, args, model, seg_cfg, bs: int, device, logger):
    """The part-segmentation trainer on the ShapeNetPart tree at
    ``config.data_root``: trainval to train (shuffled, whole batches), test
    to evaluate. Returns (train state, best metrics)."""
    from si_mamba_tpu_torch.data.shapenetpart import PartNormalDataset
    from si_mamba_tpu_torch.train.runner_seg import seg_run

    if args.test:
        raise NotImplementedError("--test of a part-segmentation checkpoint is not a path of "
                                  "the JAX CLI either: its trainer evaluates every epoch")
    npts = int(config.npoints)
    train_ds = PartNormalDataset(config.data_root, npoints=npts, split="trainval", seed=args.seed)
    test_ds = PartNormalDataset(config.data_root, npoints=npts, split="test", seed=args.seed)

    def loader(ds, shuffle):
        # one process (data parallelism is M18b); the batches are assembled
        # between the steps, as the JAX trainer's are, whatever --num_workers
        # says: a thread assembling them ahead was no faster
        # (scripts/torch_seg_loader_ab.py, PERF.md)
        return Loader(ds, bs, shuffle=shuffle, drop_last=shuffle, seed=args.seed, prefetch=0)

    pretrained = _load_pretrained(args.finetune_model) if args.finetune_model else None
    return seg_run(seg_cfg, loader(train_ds, True), loader(test_ds, False),
                   args.experiment_path, epochs=int(config.max_epoch),
                   lr=float(config.optimizer.kwargs.lr),
                   weight_decay=float(config.optimizer.kwargs.get("weight_decay", 0.0)),
                   warmup_epochs=int(config.scheduler.kwargs.initial_epochs),
                   pretrained=pretrained, logger=logger, seed=args.seed, resume=args.resume,
                   async_ckpt=bool(config.get("async_ckpt", False)), device=device,
                   model=model)


def _pretrain(config, args, model, bs: int, device, logger):
    """MAE pretraining: the train split shuffled in whole batches of
    ``total_bs``, the SVM probe's splits (``dataset.svm``, when the config
    has them) at batch 64, train shuffled and test in order, neither dropping
    a ragged batch. Returns (train state, best AccMetric)."""
    from si_mamba_tpu_torch.train.runner_pretrain import pretrain_run

    if args.test:
        raise NotImplementedError("--test of a pretraining checkpoint is not a path of the "
                                  "JAX CLI either: its runner probes every val_freq epochs")
    train_loader = build_loader(config.dataset.train, args, "train", bs, shuffle=True,
                                drop_last=True)
    svm_loaders = None
    if config.dataset.get("svm") is not None:
        svm_loaders = (
            build_loader(config.dataset.svm.train, args, "train", 64, True, False),
            build_loader(config.dataset.svm.test, args, "test", 64, False, False))
    return pretrain_run(config, train_loader, svm_loaders, args.experiment_path,
                        resume=args.resume, logger=logger, seed=args.seed,
                        val_freq=args.val_freq, device=device, model=model)


def main(argv=None):
    """Run the CLI. Returns what the run gives: the test accuracy for
    --test, (train state, best AccMetric) for a finetune, pretraining or
    part-segmentation run."""
    args = get_args(argv)
    device = resolve_device(args.device)
    snapshot = os.path.join(args.experiment_path, "config.yaml")
    if _should_auto_resume(args, snapshot):
        args.resume = True
        print(f"[AUTO-RESUME] ckpt-last.pth found in {args.experiment_path}")
    if args.resume:
        # resume re-reads the experiment's saved config, not the CLI one
        # (reference utils/config.py:48-54)
        if not os.path.exists(snapshot):
            raise FileNotFoundError(f"cannot resume: {snapshot} not found")
        args.config = snapshot
    config = get_config(args.config)
    logger = get_logger("si_mamba_tpu_torch",
                        os.path.join(args.experiment_path,
                                     f"{time.strftime('%Y%m%d_%H%M%S')}.log"))
    if args.resume:
        print_log(f"[RESUME] config re-read from {snapshot}", logger)
    else:
        save_experiment_config(config, snapshot)
    _archive_source(args.experiment_path)
    np.random.seed(args.seed)

    if args.tsne:
        rf.tsne_run(config, None, None, os.path.join(args.experiment_path, "tsne.png"), logger)
    if args.way > 0:  # few-shot: the classifier width equals the way count
        config.model.cls_dim = args.way
    # the NAME dispatch; tensor parallelism (M18b) raises here, before any
    # data is read
    rf.check_tensor_parallel(config)
    model, model_cfg = build_model_from_cfg(config.model, device, args.seed)
    bs = int(config.total_bs)
    if args.scratch_model:  # train from scratch: ignore any pretrained weights
        args.finetune_model = None
    if args.deterministic:
        print_log(f"[ARGS] deterministic run, seed={args.seed}", logger)

    if config.model.NAME == "PartSegModel":
        return _part_seg(config, args, model, model_cfg, bs, device, logger)
    if config.model.NAME == "Point_MAE_Mamba":
        return _pretrain(config, args, model, bs, device, logger)

    if args.test:
        test_loader = build_loader(config.dataset.test, args, "test", bs,
                                   shuffle=False, drop_last=False)
        if args.ckpts:
            model.load_state_dict(_load_pretrained(args.ckpts), strict=True)
        state = rf.TrainState(step=0, model=model, optimizer=None)
        return rf.test_run(config, test_loader, state, vote=args.vote, logger=logger)

    train_loader = build_loader(config.dataset.train, args, "train", bs,
                                shuffle=True, drop_last=True)
    val_loader = build_loader(config.dataset.val, args, "test", bs * 2,
                              shuffle=False, drop_last=False)
    pretrained = _load_pretrained(args.finetune_model) if args.finetune_model else None
    return rf.finetune_run(config, train_loader, val_loader, args.experiment_path,
                           pretrained=pretrained, resume=args.resume, vote=args.vote,
                           logger=logger, seed=args.seed, device=device, model=model)


if __name__ == "__main__":
    main()

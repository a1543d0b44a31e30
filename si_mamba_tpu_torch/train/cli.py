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

Over several ranks (torchrun's launch with ``SI_MAMBA_MULTIHOST=1``:
``SI_MAMBA_MULTIHOST=1 python -m torch.distributed.run --nproc_per_node W -m
si_mamba_tpu_torch.train.cli --config ...``) every path runs data-parallel,
and with ``model.tp_axis`` and ``tp_size`` the classifier tensor-parallel too
(``runner_finetune.make_run_mesh``): each rank loads its shard of every split
(``total_bs`` is the global batch), rank 0 alone writes the config snapshot,
the source archive, the log file and the checkpoints, and rank 0 builds a
missing ModelNet cache while the others wait.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from si_mamba_tpu_torch.data.datasets import build_dataset
from si_mamba_tpu_torch.data.loader import Loader
from si_mamba_tpu_torch.parallel.mesh import (
    barrier,
    data_axis,
    global_host_sum,
    maybe_initialize_distributed,
    model_axis_size,
    per_process_batch,
    rank_and_world,
    rank_device,
)
from si_mamba_tpu_torch.train import runner_finetune as rf
from si_mamba_tpu_torch.train.checkpoint import check_pth
from si_mamba_tpu_torch.train.config import ConfigDict, get_config, save_experiment_config
from si_mamba_tpu_torch.train.logging_utils import get_logger, print_log
from si_mamba_tpu_torch.train.registry import build_model_from_cfg
from si_mamba_tpu_torch.utils.weights import load_state_dict_file, shard_state_dict


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
    # this process's shard of every split: its index and the count along the
    # mesh's data axis (main sets them from the run's mesh)
    args.shard = (0, 1)
    return args


def _shard(args) -> tuple[int, int]:
    """(this process's index, the count) along the run's data axis: its shard
    of every split. The ranks of one tensor-parallel group share an index."""
    return getattr(args, "shard", (0, 1))


def _sample_seed(args):
    """The seed of a dataset that draws a sample's points: ``--seed`` on
    data index 0 (a single process's draws equal the JAX package's),
    (``--seed``, index) on another, so that no two shards draw the same
    numbers and the ranks of a tensor-parallel group draw alike."""
    index = _shard(args)[0]
    return args.seed if index == 0 else (args.seed, index)


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
                          whole=bool(others.get("whole", subset == "train")),
                          seed=_sample_seed(args))
    if name == "ModelNet":
        return name, dict(data_path=base["DATA_PATH"],
                          subset=others.get("subset", subset),
                          npoints=base.get("N_POINTS", 8192),
                          num_category=base.get("NUM_CATEGORY", 40),
                          use_normals=bool(base.get("USE_NORMALS", False)),
                          seed=_sample_seed(args))
    if name == "ModelNet40SVM":
        return name, dict(data_path=base["DATA_PATH"],
                          partition=others.get("partition", subset),
                          num_points=others.get("num_points", 2048))
    if name in ("ScanObjectNN", "ScanObjectNN_hardest"):
        return name, dict(root=base["ROOT"], subset=others.get("subset", subset),
                          seed=_sample_seed(args))
    if name == "ModelNetFewShot":
        return name, dict(data_path=base["DATA_PATH"],
                          subset=others.get("subset", subset),
                          way=args.way, shot=args.shot, fold=args.fold)
    raise KeyError(name)


def build_loader(dcfg, args, subset: str, batch_size: int, shuffle: bool,
                 drop_last: bool) -> Loader:
    """The loader of one dataset entry of the config, this process's shard
    (``args.shard``). A ModelNet cache that is missing is built with FPS on
    ``args.device``, by rank 0 while the other ranks wait."""
    name, kwargs = _dataset_kwargs(dcfg, args, subset)
    if name == "ModelNet":
        kwargs["device"] = args.device
    # rank 0 first: it writes a missing ModelNet cache, which the others read
    dataset = build_dataset(name, **kwargs) if rank_and_world()[0] == 0 else None
    barrier()
    if dataset is None:
        dataset = build_dataset(name, **kwargs)
    index, count = _shard(args)
    return Loader(dataset, batch_size=batch_size, shuffle=shuffle,
                  drop_last=drop_last, seed=args.seed, process_index=index,
                  process_count=count, prefetch=max(int(args.num_workers), 0),
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


def _part_seg(config, args, model, seg_cfg, bs: int, device, logger, mesh=None):
    """The part-segmentation trainer on the ShapeNetPart tree at
    ``config.data_root``: trainval to train (shuffled, whole batches), test
    to evaluate. Returns (train state, best metrics)."""
    from si_mamba_tpu_torch.data.shapenetpart import PartNormalDataset
    from si_mamba_tpu_torch.train.runner_seg import seg_run

    if args.test:
        raise NotImplementedError("--test of a part-segmentation checkpoint is not a path of "
                                  "the JAX CLI either: its trainer evaluates every epoch")
    npts = int(config.npoints)
    seed = _sample_seed(args)
    train_ds = PartNormalDataset(config.data_root, npoints=npts, split="trainval", seed=seed)
    test_ds = PartNormalDataset(config.data_root, npoints=npts, split="test", seed=seed)
    index, count = _shard(args)

    def loader(ds, shuffle):
        # this process's shard; the batches are assembled between the steps,
        # as the JAX trainer's are, whatever --num_workers says: a thread
        # assembling them ahead was no faster (scripts/torch_seg_loader_ab.py,
        # PERF.md)
        return Loader(ds, bs, shuffle=shuffle, drop_last=shuffle, seed=args.seed, prefetch=0,
                      process_index=index, process_count=count)

    pretrained = _load_pretrained(args.finetune_model) if args.finetune_model else None
    return seg_run(seg_cfg, loader(train_ds, True), loader(test_ds, False),
                   args.experiment_path, epochs=int(config.max_epoch),
                   lr=float(config.optimizer.kwargs.lr),
                   weight_decay=float(config.optimizer.kwargs.get("weight_decay", 0.0)),
                   warmup_epochs=int(config.scheduler.kwargs.initial_epochs),
                   pretrained=pretrained, logger=logger, seed=args.seed, resume=args.resume,
                   async_ckpt=bool(config.get("async_ckpt", False)), device=device,
                   model=model, mesh=mesh)


def _pretrain(config, args, model, bs: int, device, logger, mesh=None):
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
                        val_freq=args.val_freq, device=device, model=model, mesh=mesh)


def main(argv=None):
    """Run the CLI. Returns what the run gives: the test accuracy for
    --test, (train state, best AccMetric) for a finetune, pretraining or
    part-segmentation run."""
    args = get_args(argv)
    # the rendezvous comes first (after the flags, which name the device):
    # a failed one raises, nothing falls back to one process
    maybe_initialize_distributed(device=args.device)
    device = rank_device(args.device)
    rank = rank_and_world()[0]
    snapshot = os.path.join(args.experiment_path, "config.yaml")
    # the decision must be rank 0's on every rank: a split one would part the
    # ranks' collectives (the JAX CLI's broadcast_one_to_all)
    auto = _should_auto_resume(args, snapshot) and rank == 0
    if bool(global_host_sum(np.asarray([int(auto)]))[0]):
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
                                     f"{time.strftime('%Y%m%d_%H%M%S')}.log"), rank=rank)
    if args.resume:
        print_log(f"[RESUME] config re-read from {snapshot}", logger)
    elif rank == 0:
        save_experiment_config(config, snapshot)
    if rank == 0:
        _archive_source(args.experiment_path)
    np.random.seed(args.seed)

    if args.tsne:
        rf.tsne_run(config, None, None, os.path.join(args.experiment_path, "tsne.png"), logger)
    if args.way > 0:  # few-shot: the classifier width equals the way count
        config.model.cls_dim = args.way
    # the run's mesh (a one-sided tensor parallelism, or a tp_size that does
    # not divide the world, raises here, before any data is read), then the
    # NAME dispatch
    mesh = rf.make_run_mesh(config)
    dp = data_axis(mesh)
    if dp is not None:
        args.shard = (dp.index, dp.size)
    if model_axis_size(mesh) > 1 and args.num_workers > 1:
        # the ranks of a tensor-parallel group must load the same samples: the
        # splits that draw a sample's points draw from one generator in the
        # order the threads run (ROADMAP.md M12c), so one thread assembles them
        print_log(f"[ARGS] tensor parallelism: --num_workers {args.num_workers} -> 1", logger)
        args.num_workers = 1
    model, model_cfg = build_model_from_cfg(config.model, device, args.seed, mesh=mesh)
    bs = per_process_batch(int(config.total_bs), args.shard[1])
    if args.scratch_model:  # train from scratch: ignore any pretrained weights
        args.finetune_model = None
    if args.deterministic:
        print_log(f"[ARGS] deterministic run, seed={args.seed}", logger)

    if config.model.NAME == "PartSegModel":
        return _part_seg(config, args, model, model_cfg, bs, device, logger, mesh)
    if config.model.NAME == "Point_MAE_Mamba":
        return _pretrain(config, args, model, bs, device, logger, mesh)

    if args.test:
        test_loader = build_loader(config.dataset.test, args, "test", bs,
                                   shuffle=False, drop_last=False)
        if args.ckpts:
            sd = _load_pretrained(args.ckpts)
            tp = model.tp_sharding()
            if tp is not None:  # this rank's shard of the whole checkpoint
                sd = shard_state_dict(sd, model_cfg, tp[0].index, tp[0].size)
            model.load_state_dict(sd, strict=True)
        state = rf.TrainState(step=0, model=model, optimizer=None)
        return rf.test_run(config, test_loader, state, vote=args.vote, logger=logger)

    train_loader = build_loader(config.dataset.train, args, "train", bs,
                                shuffle=True, drop_last=True)
    val_loader = build_loader(config.dataset.val, args, "test", bs * 2,
                              shuffle=False, drop_last=False)
    pretrained = _load_pretrained(args.finetune_model) if args.finetune_model else None
    return rf.finetune_run(config, train_loader, val_loader, args.experiment_path,
                           pretrained=pretrained, resume=args.resume, vote=args.vote,
                           logger=logger, seed=args.seed, device=device, model=model,
                           mesh=mesh)


if __name__ == "__main__":
    main()

"""CLI for the port: ``python -m cmf_tpu_torch --model non-square --dataset
{sphere,hemisphere-2-6,miniboone,mnist,...} --config key=value ... [--device cpu]``,
then ``--resume <run dir>`` to train on, or one of the analyses of a finished
run: ``--test``, ``--test-ood`` (the OOD battery of an image run),
``--test-metric`` (the image metric analysis: g_kk and latent-variance
sorts, MACS, prominent-z sweeps and grids, the effective-z curves in
``test_metric/{recon,fid}.json``), ``--test-center`` (the centering
reconstructions) or ``--two-dim-manifold`` (the decoded 8×8 latent grid of a
d=2 mnist or fashion-mnist run), each with ``--resume <run dir>``.

The flags and the ``--config key=value`` mini-language are those of the JAX
package's ``main.py`` (values typed by ``ast.literal_eval``), for the subset
the port carries so far: training, resuming, the analyses above,
``--profile-dir`` (a ``torch.profiler`` trace of the second epoch),
``--print-config``, ``--print-schema``, ``--print-model`` and
``--print-num-params``, and ``--num-seeds`` with ``--grid-shard i/n`` (this
process's strided slice of the expanded config × seed jobs). ``--resume``
reads the run's ``config.json`` and ignores the other settings. Without
``--device cpu`` it runs on the card, and raises where there is none.

``--mesh data=N`` trains (and ``--test`` tests) data-parallel over N ranks,
each launched by ``torchrun --nproc_per_node N -m cmf_tpu_torch ...``
(NCCL on the card, gloo with ``--device cpu``): N must be the launcher's
world size, and N > 1 without a launcher raises. As in the JAX package's
CLI (main.py:69-72,96-111) only a ``data`` axis is accepted; without
``--mesh`` every launched rank joins the data axis, and a process that no
launcher started runs alone, with no mesh. The ranks take rank 0's seeds
and only rank 0 writes the run dir. ``--grid-shard`` stays a fan-out of
separate processes, independent of the mesh.
"""

import argparse
import ast
import contextlib
import json
import pprint
from pathlib import Path

import torch

from .config import expand_grid, get_config, get_datasets, get_models, get_schema
from .parallel import get_mesh, grid_jobs, host_shard, initialize_multihost, launched, replicate


def parse_config_arg(key_value):
    assert "=" in key_value, "Must specify config items with format `key=value`"
    k, v = key_value.split("=", maxsplit=1)
    assert k, "Config item can't have empty key"
    assert v, "Config item can't have empty value"
    try:
        v = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        v = str(v)
    return k, v


def build_parser():
    parser = argparse.ArgumentParser(prog="python -m cmf_tpu_torch")
    parser.add_argument("--resume", help="Directory of run to resume. Ignores other command-line settings for run.")
    parser.add_argument("--model", choices=get_models())
    parser.add_argument("--dataset", choices=get_datasets())
    parser.add_argument("--baseline", action="store_true", help="Run baseline flow instead of CIF")
    parser.add_argument("--num-seeds", type=int, default=1, help="Number of random seeds to use.")
    parser.add_argument("--checkpoints", choices=["best-valid", "latest", "both", "none"], default="both")
    parser.add_argument("--nosave", action="store_true", help="Don't save anything to disk")
    parser.add_argument("--data-root", default="data/", help="Location of training data")
    parser.add_argument("--logdir-root", default="runs/", help="Location of log files")
    parser.add_argument("--config", default=[], action="append", help="Override config entries as `key=value`.")
    parser.add_argument("--rundir-tail", default="", help="Suffix for the run directory name.")
    parser.add_argument("--print-config", action="store_true")
    parser.add_argument("--print-schema", action="store_true")
    parser.add_argument("--print-model", action="store_true")
    parser.add_argument("--print-num-params", action="store_true")
    parser.add_argument("--test", action="store_true", help="Test model and exit instead of training.")
    parser.add_argument("--overwrite-metrics", action="store_true")
    parser.add_argument("--test-fid", action="store_true", help="Use test dataset for FID.")
    parser.add_argument("--test-ood", action="store_true", help="Test out-of-distribution metrics.")
    parser.add_argument("--test-metric", action="store_true", help="Test metric tensor.")
    parser.add_argument("--test-center", action="store_true",
                        help="Centering analysis plots (reference experiment.py:213 centering_test_plots).")
    parser.add_argument("--two-dim-manifold", action="store_true",
                        help="Visualize the two-dim manifold for image data when d=2.")
    parser.add_argument("--synthetic-data", action="store_true",
                        help="Use shape-matched synthetic stand-ins for tabular and image data.")
    parser.add_argument("--profile-dir", default=None,
                        help="Write a torch.profiler trace of the first post-capture epoch here.")
    parser.add_argument("--mesh", default=None,
                        help="`data=N': data-parallel over the N ranks torchrun launched. "
                             "Default: every launched rank on one data axis.")
    parser.add_argument("--grid-shard", default=None,
                        help="`i/n`: run the i-th of n slices of the expanded (config×seed) grid on this host.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="Default: the card. `cpu' runs the plain PyTorch path.")
    return parser


def parse_mesh(spec):
    """``data=N`` → N (main.py:96-111: only a data axis)."""
    axis, _, n = spec.partition("=")
    if axis != "data" or not n.isdigit() or int(n) < 1:
        raise ValueError(f"--mesh takes `data=N' with N ≥ 1 (only a data axis), got `{spec}'")
    return int(n)


def make_mesh(spec, device=None):
    """The run's mesh: ``--mesh data=N`` or, under a launcher, every rank
    on the data axis; None for a process no launcher started and no
    ``--mesh`` (or ``data=1``)."""
    n = None if spec is None else parse_mesh(spec)
    if not launched() and not torch.distributed.is_initialized():
        if n is not None and n > 1:
            raise RuntimeError(
                f"--mesh data={n} needs {n} ranks: launch them with "
                f"`torchrun --nproc_per_node {n} -m cmf_tpu_torch ...'"
            )
        return None
    initialize_multihost(device=device)
    world = torch.distributed.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"--mesh data={n} but the launcher started {world} ranks")
    return get_mesh(data=world)


def _shared_seeds(jobs, mesh):
    """Every rank takes rank 0's seeds (a seed from the clock differs
    between processes)."""
    seeds = torch.tensor([int(j["seed"]) for j in jobs], dtype=torch.int64, device=mesh.device)
    replicate(mesh, [seeds])
    for j, seed in zip(jobs, seeds.tolist()):
        j["seed"] = seed
    return jobs


def main(argv=None):
    """Returns one result per job: the experiment's setup when training;
    when testing, ``test_and_visualize``'s (the results under
    ``"results"``); with ``--test-ood``, ``{"ood": {(label, split): array},
    "classification": {"<split>/<feature>": accuracy}}``; with
    ``--two-dim-manifold`` the decoded (64, C, H, W) grid; with
    ``--test-metric`` the analysis's numbers; with ``--test-center`` the
    inputs and their two reconstructions."""
    parser = build_parser()
    args = parser.parse_args(argv)
    analyses = (args.test, args.test_fid, args.test_ood, args.test_metric, args.test_center,
                args.two_dim_manifold)
    if any(analyses) and args.resume is None:
        parser.error("--test, --test-fid, --test-ood, --test-metric, --test-center and "
                     "--two-dim-manifold need --resume <run dir>")
    if args.resume is None:
        if args.model is None or args.dataset is None:
            parser.error("--model and --dataset are required without --resume")
        config = get_config(model=args.model, dataset=args.dataset, use_baseline=args.baseline)
        assert "model" not in config, "Should not specify model in config"
        assert "dataset" not in config, "Should not specify dataset in config"
        config = {"model": args.model, "dataset": args.dataset, **config}
        config = {**config, **dict(parse_config_arg(kv) for kv in args.config)}
        config = {
            **config,
            "should_checkpoint_best_valid": args.checkpoints in ["best-valid", "both"],
            "should_checkpoint_latest": args.checkpoints in ["latest", "both"],
            "write_to_disk": not args.nosave,
            "nosave": args.nosave,
            "data_root": args.data_root,
            "logdir_root": args.logdir_root,
            "rundir_tail": args.rundir_tail,
            "synthetic_data": args.synthetic_data or None,
            "profile_dir": args.profile_dir,
        }
    else:
        with open(Path(args.resume) / "config.json") as f:
            config = json.load(f)
        args.num_seeds = 1

    should_train = True
    if args.print_config:
        pprint.sorted = lambda x, key=None: x
        pprint.PrettyPrinter(indent=4).pprint(config)
        should_train = False
    grid = expand_grid(config)
    if args.print_model:
        from .training import print_model

        for c in grid:
            print_model({**c, "seed": c.get("seed", 0)}, device=args.device)
        should_train = False
    if args.print_num_params:
        from .training import print_num_params

        for c in grid:
            print_num_params({**c, "seed": c.get("seed", 0)}, device=args.device)
        should_train = False
    if args.print_schema:
        if len(grid) == 1:
            print(json.dumps(get_schema(grid[0]), indent=4))
        else:
            for i, c in enumerate(grid):
                if i > 0:
                    print()
                print("=" * 10 + f" Schema {i} " + "=" * 10 + "\n")
                print(json.dumps(get_schema(c), indent=4))
        should_train = False
    if not (should_train or args.test):
        return []

    owns_group = not torch.distributed.is_initialized()
    mesh = make_mesh(args.mesh, device=args.device)
    try:
        return _run_jobs(args, grid, mesh, analyses)
    finally:
        if owns_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run_jobs(args, grid, mesh, analyses):
    from .training import (
        centering_test_plots,
        generate_ood_metrics,
        metric_test_plots,
        ood_classification,
        test_and_visualize,
        train,
        visualize_two_dim_manifold,
    )

    if mesh is not None and mesh.size > 1 and any(analyses[2:]):
        raise ValueError("--test-ood, --test-metric, --test-center and --two-dim-manifold run on one rank")
    # Expand (config, seed) jobs, then optionally take this host's shard
    jobs = grid_jobs(grid, args.num_seeds)
    on_mesh = {}
    if mesh is not None:
        jobs = _shared_seeds(jobs, mesh)
        on_mesh = {"mesh": mesh}
    if args.grid_shard:
        i, n = (int(v) for v in args.grid_shard.split("/"))
        jobs = host_shard(jobs, i, n)
        print(f"Grid shard {i}/{n}: running {len(jobs)} of the expanded jobs")

    results = []
    with contextlib.suppress(KeyboardInterrupt):
        for c in jobs:
            if args.test or args.test_fid:
                results.append(test_and_visualize(
                    config=c, resume_dir=args.resume, overwrite=args.overwrite_metrics,
                    test_fid=args.test_fid, device=args.device, **on_mesh,
                ))
            elif args.two_dim_manifold:
                results.append(visualize_two_dim_manifold(config=c, resume_dir=args.resume, device=args.device))
            elif args.test_ood:
                ood = generate_ood_metrics(config=c, resume_dir=args.resume, device=args.device)
                results.append({"ood": ood, "classification": ood_classification(args.resume)})
            elif args.test_metric:
                results.append(metric_test_plots(config=c, resume_dir=args.resume, device=args.device))
            elif args.test_center:
                results.append(centering_test_plots(config=c, resume_dir=args.resume, device=args.device))
            else:
                results.append(train(config=c, resume_dir=args.resume, device=args.device, **on_mesh))
    return results

"""CLI for the port: ``python -m cmf_tpu_torch --model non-square --dataset
{sphere,hemisphere-2-6,miniboone,mnist,...} --config key=value ... [--device cpu]``,
then ``--resume <run dir>`` to train on, ``--test --resume <run dir>``, or
``--test-ood --resume <run dir>`` (the OOD battery of an image run).

The flags and the ``--config key=value`` mini-language are those of the JAX
package's ``main.py`` (values typed by ``ast.literal_eval``), for the subset
the port carries so far: training, resuming, the test pass and the OOD
battery, and ``--print-config``, ``--print-schema`` and
``--print-num-params``. ``--resume``
reads the run's ``config.json`` and ignores the other settings. Without
``--device cpu`` it runs on the card, and raises where there is none.
"""

import argparse
import ast
import json
import pprint
import time
from pathlib import Path

from .config import expand_grid, get_config, get_datasets, get_models, get_schema


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
    parser.add_argument("--print-num-params", action="store_true")
    parser.add_argument("--test", action="store_true", help="Test model and exit instead of training.")
    parser.add_argument("--overwrite-metrics", action="store_true")
    parser.add_argument("--test-fid", action="store_true", help="Use test dataset for FID.")
    parser.add_argument("--test-ood", action="store_true", help="Test out-of-distribution metrics.")
    parser.add_argument("--synthetic-data", action="store_true",
                        help="Use shape-matched synthetic stand-ins for tabular and image data.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="Default: the card. `cpu' runs the plain PyTorch path.")
    return parser


def main(argv=None):
    """Returns one result per job: the experiment's setup when training;
    when testing, ``test_and_visualize``'s (the results under
    ``"results"``); with ``--test-ood``, ``{"ood": {(label, split): array},
    "classification": {"<split>/<feature>": accuracy}}``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.test or args.test_fid or args.test_ood) and args.resume is None:
        parser.error("--test, --test-fid and --test-ood need --resume <run dir>")
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
    if args.print_num_params:
        from .training import print_num_params

        for c in grid:
            print_num_params({**c, "seed": c.get("seed", 0)}, device=args.device)
        should_train = False
    if args.print_schema:
        for c in grid:
            print(json.dumps(get_schema(c), indent=4))
        should_train = False
    if not (should_train or args.test):
        return []

    from .training import generate_ood_metrics, ood_classification, test_and_visualize, train

    results = []
    for c in grid:
        for _ in range(args.num_seeds):
            if "seed" not in c or args.num_seeds > 1:
                c = {**c, "seed": int(time.time() * 1e6) % 2**32}
            if args.test or args.test_fid:
                results.append(test_and_visualize(
                    config=dict(c), resume_dir=args.resume, overwrite=args.overwrite_metrics,
                    test_fid=args.test_fid, device=args.device,
                ))
            elif args.test_ood:
                ood = generate_ood_metrics(config=dict(c), resume_dir=args.resume, device=args.device)
                results.append({"ood": ood, "classification": ood_classification(args.resume)})
            else:
                results.append(train(config=dict(c), resume_dir=args.resume, device=args.device))
    return results

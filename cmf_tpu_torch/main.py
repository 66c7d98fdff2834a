"""CLI for the port: ``python -m cmf_tpu_torch --model non-square --dataset
{miniboone,mnist} --synthetic-data --nosave --config key=value ...
[--device cpu]``.

The flags and the ``--config key=value`` mini-language are those of the JAX
package's ``main.py`` (values typed by ``ast.literal_eval``), for the subset
the port carries so far: training only. Without ``--device cpu`` it runs on
the card, and raises where there is none.
"""

import argparse
import ast
import json
import pprint
import time

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
    parser.add_argument("--model", choices=get_models(), required=True)
    parser.add_argument("--dataset", choices=get_datasets(), required=True)
    parser.add_argument("--baseline", action="store_true", help="Run baseline flow instead of CIF")
    parser.add_argument("--num-seeds", type=int, default=1, help="Number of random seeds to use.")
    parser.add_argument("--nosave", action="store_true", help="Don't save anything to disk")
    parser.add_argument("--data-root", default="data/", help="Location of training data")
    parser.add_argument("--config", default=[], action="append", help="Override config entries as `key=value`.")
    parser.add_argument("--print-config", action="store_true")
    parser.add_argument("--print-schema", action="store_true")
    parser.add_argument("--synthetic-data", action="store_true",
                        help="Use shape-matched synthetic stand-ins for tabular and image data.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="Default: the card. `cpu' runs the plain PyTorch path.")
    return parser


def main(argv=None):
    """Returns the list of finished experiment setups (one per job)."""
    args = build_parser().parse_args(argv)
    config = get_config(model=args.model, dataset=args.dataset, use_baseline=args.baseline)
    assert "model" not in config, "Should not specify model in config"
    assert "dataset" not in config, "Should not specify dataset in config"
    config = {"model": args.model, "dataset": args.dataset, **config}
    config = {**config, **dict(parse_config_arg(kv) for kv in args.config)}
    config = {
        **config,
        "write_to_disk": not args.nosave,
        "nosave": args.nosave,
        "data_root": args.data_root,
        "synthetic_data": args.synthetic_data or None,
    }

    should_train = True
    if args.print_config:
        pprint.sorted = lambda x, key=None: x
        pprint.PrettyPrinter(indent=4).pprint(config)
        should_train = False
    grid = expand_grid(config)
    if args.print_schema:
        for c in grid:
            print(json.dumps(get_schema(c), indent=4))
        should_train = False
    if not should_train:
        return []

    from .training import train

    setups = []
    for c in grid:
        for _ in range(args.num_seeds):
            if "seed" not in c or args.num_seeds > 1:
                c = {**c, "seed": int(time.time() * 1e6) % 2**32}
            setups.append(train(config=dict(c), device=args.device))
    return setups

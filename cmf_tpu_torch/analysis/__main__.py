"""Tables over a root of run dirs:

    python -m cmf_tpu_torch.analysis fid [--runs runs] [--out fid_table.csv]
    python -m cmf_tpu_torch.analysis ood [--runs runs] [--out ood_table.csv]
    python -m cmf_tpu_torch.analysis tabular [--runs runs] [--out tabular_table.csv] [--retest] [--device cpu]

``fid`` is the FID table keyed by (dataset, λ, d), ``ood`` the OOD table per
run, split and feature, and ``tabular`` the RNF-vs-CMF table: the test FID
keyed by (dataset, λ), mean ± stderr over seeds. ``tabular --retest`` first
runs ``test_and_visualize`` (on the card unless ``--device cpu``) on every run
dir that lacks ``metrics.json``.
"""

import argparse

from .collect import aggregate, collect_fid, collect_ood, scan_runs, write_csv


def build_parser():
    parser = argparse.ArgumentParser(prog="python -m cmf_tpu_torch.analysis")
    sub = parser.add_subparsers(dest="table", required=True)
    for name in ("fid", "ood", "tabular"):
        p = sub.add_parser(name)
        p.add_argument("--runs", default="runs")
        p.add_argument("--out", default=f"{name}_table.csv")
    tabular = sub.choices["tabular"]
    tabular.add_argument("--retest", action="store_true", help="Run the test on runs missing metrics.json")
    tabular.add_argument("--device", choices=["cuda", "cpu"], default=None,
                         help="Device of --retest. Default: the card.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.table == "fid":
        rows = collect_fid(args.runs, out_csv=args.out)
    elif args.table == "ood":
        rows = collect_ood(args.runs, out_csv=args.out)
    else:
        if args.retest:
            from ..training import test_and_visualize

            for run_dir, config, metrics in list(scan_runs(args.runs, require_metrics=False)):
                if metrics is None:
                    print(f"re-testing {run_dir}")
                    test_and_visualize(config, run_dir, device=args.device)
        key_fields = ("dataset", "metric_regularization_param")
        rows = aggregate(scan_runs(args.runs), key_fields, "fid")
        write_csv(rows, args.out, key_fields, label="fid")
    for r in rows:
        print(r)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()

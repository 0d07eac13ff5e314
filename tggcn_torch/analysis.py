"""The analysis entry point of the port (counterpart of the root
``analysis.py``, reference analysis.py:12-143): result diffing and plots.

    python -m tggcn_torch.analysis <subcommand> [arguments]

Subcommands:
    performance_diff  - diff two per-example F1 score dumps
    plot_comparison   - stacked segmentation bar plots from gt/our JSON dumps
    plot_curves       - training-loss curves from a run checkpoint
"""

import argparse
import json
import os


def performance_diff(args):
    """Diff per-example F1 files written by either package's predict
    (dump_f1_scores_per_example)."""
    def read_scores(path):
        scores = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, _, value = line.rpartition(": ")
                scores[key] = float(value)
        return scores

    first = read_scores(args.first_file)
    second = read_scores(args.second_file)
    diffs = []
    for key in sorted(set(first) & set(second)):
        diffs.append((second[key] - first[key], key))
    diffs.sort(reverse=not args.ascending)
    for diff, key in diffs[: args.top_k if args.top_k else None]:
        print(f"{key}: {first[key]:.4f} -> {second[key]:.4f} ({diff:+.4f})")
    only_first = set(first) - set(second)
    only_second = set(second) - set(first)
    if only_first:
        print(f"Only in first: {sorted(only_first)}")
    if only_second:
        print(f"Only in second: {sorted(only_second)}")


def plot_comparison(args):
    """Stacked GT + per-model segmentation bars from gt/our JSON dumps."""
    from tggcn_torch.visualisation import plot_segmentation

    with open(args.ground_truth_file) as f:
        gt = json.load(f)
    predictions = []
    for prediction_file in args.prediction_files:
        with open(prediction_file) as f:
            predictions.append(json.load(f))
    os.makedirs(args.save_dir, exist_ok=True)
    class_id_to_label = None
    if args.class_dictionary:
        with open(args.class_dictionary) as f:
            class_id_to_label = {int(k): v for k, v in json.load(f).items()}
    for video_id, entities in gt.items():
        for ent_id, gt_labels in entities.items():
            preds = [p.get(video_id, {}).get(ent_id) for p in predictions]
            preds = [p for p in preds if p is not None]
            if not gt_labels:
                continue
            if class_id_to_label is None:
                num_classes = int(max(gt_labels)) + 1
                mapping = {i: str(i) for i in range(num_classes)}
            else:
                mapping = class_id_to_label
            save_file = os.path.join(args.save_dir, f"{video_id}_{ent_id}.png")
            plot_segmentation([int(v) for v in gt_labels],
                              *[[int(v) for v in p] for p in preds],
                              class_id_to_label=mapping, save_file=save_file,
                              xlabels_type="id")
    print(f"wrote plots to {args.save_dir}")


def plot_curves(args):
    """Training/validation loss curves from a run checkpoint."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from tggcn_torch.train.checkpoint import load_run_checkpoint

    # Either package's .ckpt run dirs and reference .tar (torch) run dirs
    # (reference analysis.py:78-90 reads the same keys from its .tar).
    checkpoint = load_run_checkpoint(args.model_dir)
    plt.figure()
    for key, label in [("train_losses", "train"), ("val_losses", "val")]:
        losses = checkpoint.get(key) or []
        if losses:
            plt.plot([total for total, _ in losses], label=label)
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.legend()
    save_file = args.save_file or os.path.join(args.model_dir, "loss_curves.png")
    plt.savefig(save_file, bbox_inches="tight")
    plt.close()
    print(f"wrote {save_file}")


def create_arg_parser():
    parser = argparse.ArgumentParser(description="Analysis Module.")
    subparsers = parser.add_subparsers(required=True)

    diff = subparsers.add_parser("performance_diff",
                                 help="Diff two per-example F1 score files.")
    diff.add_argument("first_file", type=str)
    diff.add_argument("second_file", type=str)
    diff.add_argument("--top_k", type=int, default=0)
    diff.add_argument("--ascending", action="store_true")
    diff.set_defaults(func=performance_diff)

    cmp_ = subparsers.add_parser("plot_comparison",
                                 help="Plot GT vs prediction segmentation bars.")
    cmp_.add_argument("ground_truth_file", type=str)
    cmp_.add_argument("prediction_files", type=str, nargs="+")
    cmp_.add_argument("--save_dir", type=str, required=True)
    cmp_.add_argument("--class_dictionary", type=str)
    cmp_.set_defaults(func=plot_comparison)

    curves = subparsers.add_parser("plot_curves", help="Plot training loss curves.")
    curves.add_argument("model_dir", type=str)
    curves.add_argument("--save_file", type=str)
    curves.set_defaults(func=plot_curves)
    return parser


def main(argv=None):
    args = create_arg_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()

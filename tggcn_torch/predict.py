"""The predict entry point (counterpart of the root ``predict.py``): the same
flags and outputs.

    python -m tggcn_torch.predict --pretrained_model_dir outputs/<data>/<model>/<run> \
        [--cross_validate] [--convert_frame_to_segment_level] \
        [--save_visualisations_dir DIR] [--inspect_model] [--device cpu]

Run-dir discovery through the frozen .hydra/config.yaml (a run dir of the
port, of the JAX package or a reference .tar), batch-128 inference on the
card (unless ``--device cpu``; raises without a card) with labels kept at
full FPS and predictions upsampled by frame repetition, the Bimanual
15-FPS fixup, per-subject micro/macro P/R/F1 + F1@{0.10,0.25,0.50},
cross-validated aggregation over the sibling _SubjectX run dirs,
optional segmentation visualisations, per-example F1 dumps and gt/our JSON
label dumps. The engine is ``tggcn_torch/eval``.
"""

import argparse
import os

import numpy as np

from tggcn_torch.eval.engine import run_inference
from tggcn_torch.eval.reporting import (
    OVERLAPS,
    dump_f1_scores_per_example,
    dump_label_jsons,
    dump_visualisations,
    evaluate_f1_at_k,
    evaluate_predictions,
    print_cross_validation_summary,
)
from tggcn_torch.eval.rundir import RunDir, class_names_in_id_order
from tggcn_torch.runtime import check_parity_mode, resolve_device
from tggcn_torch.utils.io import cleanup_directory



def predict(model_dir, frame_to_segment_level=False, inspect_model=False, device=None):
    """Run inference for one trained run dir, on the card unless device says
    otherwise; returns (outputs, targets, ids)."""
    outputs, targets, test_ids, attentions = run_inference(
        RunDir(model_dir), frame_to_segment_level, inspect_model, device=device)
    if inspect_model and attentions is not None:
        att_path = os.path.join(model_dir, "attention_scores.npz")
        np.savez(att_path, **{f"source_{i}": a for i, a in enumerate(attentions)})
        print(f"Saved attention scores to {att_path}")
    return outputs, targets, test_ids


def _evaluate_fold(outputs, targets, subactivity_names, affordance_names):
    """Frame metrics + F1@k sweep for one fold; returns both result dicts."""
    frame_results = evaluate_predictions(targets, outputs,
                                         subactivity_names=subactivity_names,
                                         affordance_names=affordance_names)
    num_sa = len(subactivity_names) if subactivity_names else None
    num_af = len(affordance_names) if affordance_names else None
    f1_results = {overlap: evaluate_f1_at_k(targets, outputs, num_sa, num_af,
                                            overlap=overlap)
                  for overlap in OVERLAPS}
    return frame_results, f1_results


def _dump_fold_artifacts(save_dir, outputs, targets, test_ids,
                         subactivity_id_to_name, affordance_id_to_name):
    os.makedirs(save_dir, exist_ok=True)
    cleanup_directory(save_dir)
    dump_visualisations(save_dir, outputs, targets, test_ids,
                        subactivity_id_to_name, affordance_id_to_name)
    for overlap in OVERLAPS:
        dump_f1_scores_per_example(save_dir, outputs, targets, test_ids,
                                   subactivity_id_to_name, affordance_id_to_name,
                                   overlap)


def predict_all(args):
    device = resolve_device(getattr(args, "device", None))
    run = RunDir(args.pretrained_model_dir)
    check_parity_mode(run.cfg.get("resources", default_value={}).get("parity_mode", "fast"))
    subactivity_id_to_name, affordance_id_to_name = run.class_dictionaries()
    subactivity_names = class_names_in_id_order(subactivity_id_to_name)
    affordance_names = class_names_in_id_order(affordance_id_to_name)

    if not args.cross_validate:
        outputs, targets, test_ids = predict(
            args.pretrained_model_dir, args.convert_frame_to_segment_level,
            args.inspect_model, device)
        _evaluate_fold(outputs, targets, subactivity_names, affordance_names)
        if args.save_visualisations_dir is not None and \
                os.path.isdir(args.save_visualisations_dir):
            subject_id = args.pretrained_model_dir.split(sep="_")[-1]
            _dump_fold_artifacts(
                os.path.join(args.save_visualisations_dir, subject_id),
                outputs, targets, test_ids,
                subactivity_id_to_name, affordance_id_to_name)
        return

    # Cross-validation: evaluate every sibling _<subject> run dir that exists.
    outputs_per_subject = {}
    for subject_id, fold_dir in run.sibling_fold_paths():
        try:
            outputs_per_subject[subject_id] = predict(
                fold_dir, args.convert_frame_to_segment_level, args.inspect_model, device)
        except FileNotFoundError:
            continue

    results_per_subject, f1_results_per_subject = {}, {}
    for subject_id, (outputs, targets, _) in sorted(outputs_per_subject.items()):
        print(f"\n{subject_id}")
        results_per_subject[subject_id], f1_results_per_subject[subject_id] = \
            _evaluate_fold(outputs, targets, subactivity_names, affordance_names)
    print_cross_validation_summary(results_per_subject, f1_results_per_subject)

    if args.save_visualisations_dir is not None and \
            os.path.isdir(args.save_visualisations_dir):
        for subject_id, (outputs, targets, test_ids) in outputs_per_subject.items():
            _dump_fold_artifacts(
                os.path.join(args.save_visualisations_dir, subject_id),
                outputs, targets, [f"{subject_id}_{t}" for t in test_ids],
                subactivity_id_to_name, affordance_id_to_name)
        dump_label_jsons(args.save_visualisations_dir, outputs_per_subject)


def create_arg_parser():
    parser = argparse.ArgumentParser(description="Predict Module.")
    parser.add_argument("--pretrained_model_dir", type=str, required=True,
                        help="Path to directory containing the pre-trained model information.")
    parser.add_argument("--cross_validate", action="store_true",
                        help="Evaluate all sibling _SubjectX runs and average their results.")
    parser.add_argument("--convert_frame_to_segment_level", action="store_true",
                        help="Convert frame-level predictions into segment-level predictions "
                             "(only meaningful with ground-truth segmentation inputs).")
    parser.add_argument("--save_visualisations_dir", type=str,
                        help="If specified, save ground-truth/predicted segmentations there "
                             "(directory must exist).")
    parser.add_argument("--inspect_model", action="store_true",
                        help="Fetch attention scores from the model and save them "
                             "to <run_dir>/attention_scores.npz.")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default; raises without a CUDA device) or cpu.")
    parser.set_defaults(func=predict_all)
    return parser


def main(argv=None):
    args = create_arg_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()

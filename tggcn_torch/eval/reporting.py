"""Metrics, cross-validation aggregation and artifact dumps for evaluation
(counterpart of ``tggcn/eval/reporting.py``).

Print formats follow the reference CLI's stdout contract
(reference predict.py:205-246, 351-383); the artifact dumps (segmentation
PNGs, per-example F1 text files, gt/our label JSONs) match the files the
reference writes (predict.py:395-472). The frame metrics are scikit-learn's
``precision_recall_fscore_support`` and ``classification_report``
computed in numpy (the card's machine has no scikit-learn): the labels
seen in the targets or the outputs, a quotient with a zero denominator
taken as 0.
"""

import json
import os
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tggcn_torch.utils.io import cleanup_directory
# F1@k in native/libfastmetrics.so where it is built, else in numpy (utils/native.py).
from tggcn_torch.utils.native import f1_at_k, f1_at_k_single_example

OVERLAPS = [0.10, 0.25, 0.50]


def _head_kind(head_name: str) -> Tuple[str, str]:
    """(problem class, problem type) printable names for an output head."""
    problem_type = "Recognition" if "recognition" in head_name else "Prediction"
    problem_class = "Affordance" if "affordance" in head_name else "Sub-activity"
    return problem_class, problem_type


def _divide(numerator, denominator):
    """numerator / denominator, 0 where the denominator is 0."""
    numerator, denominator = np.asarray(numerator, float), np.asarray(denominator, float)
    out = np.zeros(np.broadcast(numerator, denominator).shape)
    np.divide(numerator, denominator, out=out, where=denominator != 0)
    return out


def per_label_scores(target: np.ndarray, output: np.ndarray, labels) -> tuple:
    """(precision, recall, f1, support) per label of ``labels``, as
    scikit-learn's ``precision_recall_fscore_support(average=None,
    zero_division=0)``."""
    labels = np.asarray(list(labels))
    tp = np.array([np.sum((output == k) & (target == k)) for k in labels])
    predicted = np.array([np.sum(output == k) for k in labels])
    support = np.array([np.sum(target == k) for k in labels])
    return (_divide(tp, predicted), _divide(tp, support),
            _divide(2 * tp, predicted + support), support)


def precision_recall_f1(target: np.ndarray, output: np.ndarray, average: str) -> tuple:
    """scikit-learn's ``precision_recall_fscore_support(target, output,
    average=average, zero_division=0)[:3]`` for 'micro' and 'macro', over
    the labels seen in target or output."""
    labels = np.union1d(np.unique(target), np.unique(output))
    if average == "micro":
        tp = float(np.sum(output == target))
        precision = recall = float(_divide(tp, output.size))
        return precision, recall, float(_divide(2 * tp, output.size + target.size))
    if average != "macro":
        raise ValueError(f"average must be 'micro' or 'macro', not {average!r}")
    if labels.size == 0:
        return 0.0, 0.0, 0.0
    precision, recall, f1, _ = per_label_scores(target, output, labels)
    return float(precision.mean()), float(recall.mean()), float(f1.mean())


def classification_report(target: np.ndarray, output: np.ndarray, labels, target_names,
                          digits: int = 4) -> str:
    """The text of scikit-learn's ``classification_report`` for the given
    labels: a row per class, then accuracy, macro and weighted averages."""
    precision, recall, f1, support = per_label_scores(target, output, labels)
    names = list(target_names) if target_names is not None else [str(k) for k in labels]
    width = max([len(n) for n in names] + [len("weighted avg"), digits])
    head = ["precision", "recall", "f1-score", "support"]
    lines = [f"{'':>{width}} " + " ".join(f"{h:>9}" for h in head), ""]
    row = "{:>{w}} " + " {:>9.{d}f}" * 3 + " {:>9}"
    for name, p, r, f, n in zip(names, precision, recall, f1, support):
        lines.append(row.format(name, p, r, f, int(n), w=width, d=digits))
    lines.append("")
    total = int(support.sum())
    accuracy = float(_divide(np.sum(output == target), target.size))
    lines.append(f"{'accuracy':>{width}} {'':>9} {'':>9} {accuracy:>9.{digits}f} {total:>9}")
    weights = _divide(support, total)
    for name, reduce in (("macro avg", np.mean),
                         ("weighted avg", lambda v: float(np.sum(v * weights)))):
        lines.append(row.format(name, reduce(precision), reduce(recall), reduce(f1), total,
                                w=width, d=digits))
    return "\n".join(lines) + "\n"


def evaluate_predictions(targets: Dict[str, np.ndarray],
                         outputs: Dict[str, np.ndarray], print_report: bool = True,
                         subactivity_names: Optional[List[str]] = None,
                         affordance_names: Optional[List[str]] = None) -> dict:
    """Frame-level micro/macro P/R/F1 per head over non-padding frames."""
    results = {}
    for head, target in sorted(targets.items()):
        target = target.reshape(-1)
        output = outputs[head].reshape(-1)[target != -1]
        target = target[target != -1]
        if print_report:
            problem_class, problem_type = _head_kind(head)
            target_names = (affordance_names if problem_class == "Affordance"
                            else subactivity_names)
            print(f"{problem_class} {problem_type}")
            print(classification_report(target, output, labels=range(len(target_names)),
                                        target_names=target_names, digits=4))
        for average in ["micro", "macro"]:
            precision, recall, f1 = precision_recall_f1(target, output, average)
            results[f"{head}-{average}"] = {"precision": precision,
                                            "recall": recall, "f1": f1}
    return results


def evaluate_f1_at_k(targets: Dict[str, np.ndarray], outputs: Dict[str, np.ndarray],
                     num_subactivities: Optional[int], num_affordances: Optional[int],
                     overlap: float = 0.25) -> Dict[str, float]:
    """Segmental F1@overlap per head, averaged over (video, entity) tracks."""
    results = {}
    print(f"\n\nF1@{overlap} metric.")
    for head, target in sorted(targets.items()):
        output = outputs[head]
        if target.ndim == 3:  # (N, T, E) -> one row per entity track
            target = np.swapaxes(target, 1, 2)
            output = np.swapaxes(output, 1, 2)
        num_steps = target.shape[-1]
        problem_class, problem_type = _head_kind(head)
        num_classes = (num_affordances if problem_class == "Affordance"
                       else num_subactivities)
        f1 = f1_at_k(target.reshape(-1, num_steps), output.reshape(-1, num_steps),
                     num_classes, overlap=overlap, ignore_value=-1.0)
        print(f"{problem_class} {problem_type}")
        print(f"F1@{overlap}: {f1:.4f}")
        results[head] = f1
    return results


def print_cross_validation_summary(results_per_subject: dict,
                                   f1_results_per_subject: dict) -> None:
    """Mean/std aggregation across CV folds (reference predict.py:354-383)."""
    frame_metrics = defaultdict(list)
    for _subject, results_per_head in sorted(results_per_subject.items()):
        for head, metrics in results_per_head.items():
            for metric_name, value in metrics.items():
                frame_metrics[f"{head}_{metric_name}"].append(value)
    print("\n\nSummary Performance for Cross-validation.")
    for metric_id, values in frame_metrics.items():
        print(f"{metric_id}\n\tValues: {[round(v, 4) for v in values]}")
        print(f"\tMean: {np.mean(values):.4f}\tStd: {np.std(values):.4f}")

    f1_by_head = {}
    for _subject, f1_per_overlap in sorted(f1_results_per_subject.items()):
        for overlap, f1_per_head in sorted(f1_per_overlap.items()):
            for head, value in f1_per_head.items():
                f1_by_head.setdefault(head, {}).setdefault(overlap, []).append(value)
    print("\nSummary F1@k results.")
    for head, f1s_per_overlap in f1_by_head.items():
        print(f"{head}")
        for overlap, values in f1s_per_overlap.items():
            print(f"\tOverlap: {overlap}")
            print(f"\tValues: {[round(v, 4) for v in values]}")
            print(f"\tMean: {np.mean(values):.4f}\tStd: {np.std(values):.4f}\n")


def iter_entity_tracks(outputs: Dict[str, np.ndarray],
                       targets: Dict[str, np.ndarray],
                       test_ids: List[str]) -> Iterator[tuple]:
    """Yield (head, test_id, entity_id, gt_track, pred_track) per entity.

    Tracks are 1-D label sequences with GT padding frames removed; all-padding
    tracks are skipped. Shared walker behind every per-example dump.
    """
    for head, output in outputs.items():
        target = targets[head]
        for out_video, tgt_video, test_id in zip(output, target, test_ids):
            for entity in range(out_video.shape[1]):
                gt_track = tgt_video[:, entity]
                pred_track = out_video[:, entity][gt_track != -1]
                gt_track = gt_track[gt_track != -1]
                if gt_track.size:
                    yield head, test_id, entity, gt_track, pred_track


def dump_visualisations(save_dir: str, outputs, targets, test_ids,
                        subactivity_id_to_name, affordance_id_to_name) -> None:
    """One segmentation-bar PNG per (video, head, entity)."""
    from tggcn_torch.visualisation import plot_segmentation

    for head, test_id, entity, gt, pred in iter_entity_tracks(outputs, targets,
                                                              test_ids):
        id_to_name = (subactivity_id_to_name if "sub-activity" in head
                      else affordance_id_to_name)
        plot_segmentation(list(gt), list(pred), class_id_to_label=id_to_name,
                          save_file=os.path.join(save_dir,
                                                 f"{test_id}_{head}_{entity}.png"),
                          xlabels_type="id")


def dump_f1_scores_per_example(save_dir: str, outputs, targets, test_ids,
                               subactivity_id_to_name, affordance_id_to_name,
                               overlap: float) -> None:
    """Per-(video, head, entity) F1@overlap scores as a text file."""
    lines_by_head = defaultdict(list)
    for head, test_id, entity, gt, pred in iter_entity_tracks(outputs, targets,
                                                              test_ids):
        id_to_name = (subactivity_id_to_name if "sub-activity" in head
                      else affordance_id_to_name)
        f1 = f1_at_k_single_example(gt, pred, len(id_to_name), overlap=overlap)
        lines_by_head[head].append(f"{head}_{test_id}_{entity}: {f1:.4f}\n")
    with open(os.path.join(save_dir, f"f1_scores_{overlap:.2f}.txt"), "w") as f:
        for head in outputs:
            f.writelines(lines_by_head.get(head, []))
            f.write("\n")


def dump_label_jsons(save_dir: str, outputs_per_subject: dict) -> None:
    """gt/our x sa/af JSON label dumps consumed by analysis.py plot_comparison."""
    dumps = {"gt_sa": {}, "our_sa": {}, "gt_af": {}, "our_af": {}}
    for output, target, test_ids in outputs_per_subject.values():
        for short, head in (("sa", "sub-activity_recognition"),
                            ("af", "affordance_recognition")):
            if head not in target:
                continue
            for vid, gt_video, pred_video in zip(test_ids, target[head],
                                                 output[head]):
                gt_entry = dumps[f"gt_{short}"].setdefault(vid, {})
                pred_entry = dumps[f"our_{short}"].setdefault(vid, {})
                for entity in range(gt_video.shape[1]):
                    gt_track = gt_video[:, entity]
                    pred_track = pred_video[:, entity][gt_track != -1.0]
                    gt_track = gt_track[gt_track != -1.0]
                    if gt_track.size:
                        gt_entry[entity + 1] = gt_track.tolist()
                        pred_entry[entity + 1] = pred_track.tolist()

    out_dir = os.path.join(save_dir, "outputs")
    os.makedirs(out_dir, exist_ok=True)
    cleanup_directory(out_dir)
    for name, labels_by_video in dumps.items():
        if not labels_by_video:
            continue
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(labels_by_video, f)

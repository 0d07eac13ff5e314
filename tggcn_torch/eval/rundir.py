"""Trained-run-directory discovery (counterpart of ``tggcn/eval/rundir.py``).

A run dir (outputs/<data>/<model>/<name>/, SURVEY.md §5.4) is the unit of
evaluation: it holds the frozen Hydra config under .hydra/config.yaml, a
checkpoint named after the directory, and (for cross-validation) sibling
directories that differ only in the trailing _<subject> suffix
(reference predict.py:22-43, 266-300, 329-342).
"""

import json
import os
from typing import Dict, List, Optional, Tuple

from tggcn_torch.config import load_config
from tggcn_torch.utils.io import read_dictionary

CV_FOLDS = {
    "cad120": ["Subject1", "Subject3", "Subject4", "Subject5"],
    "bimanual": ["1", "2", "3", "4", "5", "6"],
    "mphoi": ["Subject45", "Subject25", "Subject14"],
}


class RunDir:
    """Lazy accessor over one trained run directory."""

    def __init__(self, path: str):
        self.path = os.path.normpath(path)
        self.basename = os.path.basename(self.path)
        self.cfg = load_config(os.path.join(self.path, ".hydra", "config.yaml"))

    @property
    def dataset_name(self) -> str:
        return self.cfg.data.get("name", default_value="cad120")

    @property
    def model_name(self) -> str:
        return self.cfg.metadata.model_name

    @property
    def input_type(self) -> str:
        return self.cfg.metadata.input_type

    @property
    def misc(self) -> dict:
        return self.cfg.get("misc", default_value={})

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.path, self.basename + ".ckpt")

    def load_scalers(self):
        """Feature scalers stored inside the training checkpoint, if any."""
        from tggcn_torch.train.checkpoint import load_checkpoint

        if os.path.exists(self.checkpoint_path):
            return load_checkpoint(self.checkpoint_path).get("scalers", None)
        return None

    def sibling_fold_paths(self) -> List[Tuple[str, str]]:
        """(subject_id, run-dir path) for every CV fold of this run's dataset.

        Folds are addressed by swapping the final _<subject> token of the
        run-dir name; missing sibling dirs are the caller's concern.
        """
        stem = "_".join(self.basename.split("_")[:-1])
        parent = os.path.dirname(self.path)
        return [(subject, os.path.join(parent, f"{stem}_{subject}"))
                for subject in CV_FOLDS.get(self.dataset_name, [])]

    def class_dictionaries(self) -> Tuple[Optional[Dict[int, str]],
                                          Optional[Dict[int, str]]]:
        """(sub-activity, affordance) id -> name maps for this dataset.

        CAD-120 ships 1-based txt dictionaries next to the subject map (both
        optional); Bimanual/MPHOI ship 0-based JSON maps next to their data
        roots.
        """
        dataset = self.dataset_name
        if dataset == "cad120":
            root = os.path.dirname(self.cfg.data.video_id_to_subject_id)
            return (_read_txt_dictionary(root, "subactivity-id_to_subactivity-name.txt"),
                    _read_txt_dictionary(root, "affordance-id_to_affordance-name.txt"))
        if dataset == "bimanual":
            root = os.path.dirname(self.cfg.data.video_id_to_video_fps)
            return _read_json_dictionary(root, "bimacs_action_id_to_action_name.json"), None
        root = os.path.dirname(self.cfg.data.path)
        return _read_json_dictionary(root, "mphoi_action_id_to_action_name.json"), None


def _read_txt_dictionary(root: str, filename: str) -> Optional[Dict[int, str]]:
    try:
        raw = read_dictionary(os.path.join(root, filename))
    except FileNotFoundError:
        return None
    return {int(key) - 1: name for key, name in raw.items()}


def _read_json_dictionary(root: str, filename: str) -> Dict[int, str]:
    with open(os.path.join(root, filename)) as f:
        return {int(key): name for key, name in json.load(f).items()}


def class_names_in_id_order(id_to_name: Optional[Dict[int, str]]) -> Optional[List[str]]:
    if id_to_name is None:
        return None
    return [id_to_name[key] for key in sorted(id_to_name)]

"""CAD-120 cross-validation split helper (counterpart of
``tggcn/data/cross_validation.py``, reference vhoi/cross_validation.py:11-28).

    python -m tggcn_torch.data.cross_validation <annotations_root> <output_path>

Crawls the CAD-120 annotations tree (SubjectN_annotations/<task>/...) to
produce the video-id -> subject map consumed by the leave-one-subject-out
loaders, and writes it in the 'video_id Subject' text format of
video-id_to_subject.txt.
"""

import os
from typing import Dict


def build_video_id_to_subject_map(annotations_root: str) -> Dict[str, str]:
    """Map each video id to its subject by crawling SubjectX_annotations dirs."""
    mapping = {}
    for entry in sorted(os.listdir(annotations_root)):
        if "_annotations" not in entry:
            continue
        subject = entry.split("_annotations")[0]
        subject_dir = os.path.join(annotations_root, entry)
        if not os.path.isdir(subject_dir):
            continue
        for task in sorted(os.listdir(subject_dir)):
            task_dir = os.path.join(subject_dir, task)
            if not os.path.isdir(task_dir):
                continue
            for name in sorted(os.listdir(task_dir)):
                video_id = None
                if os.path.isdir(os.path.join(task_dir, name)):
                    video_id = name
                elif name.endswith(".txt") and name[:-4].isdigit():
                    video_id = name[:-4]
                if video_id is not None and video_id.isdigit():
                    mapping[video_id] = subject
    return mapping


def write_video_id_to_subject_map(mapping: Dict[str, str], output_path: str) -> None:
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    with open(output_path, mode="w") as f:
        for video_id, subject in sorted(mapping.items()):
            f.write(f"{video_id} {subject}\n")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Build the CAD-120 video->subject map.")
    parser.add_argument("annotations_root", type=str)
    parser.add_argument("output_path", type=str)
    args = parser.parse_args(argv)
    mapping = build_video_id_to_subject_map(args.annotations_root)
    write_video_id_to_subject_map(mapping, args.output_path)
    print(f"wrote {len(mapping)} entries to {args.output_path}")


if __name__ == "__main__":
    main()

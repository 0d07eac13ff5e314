"""The port's tools against the JAX package's originals on the same inputs:
``python -m tggcn_torch.analysis`` (``performance_diff``'s output,
``plot_curves`` from a port run dir, a JAX run dir and a reference
``.tar``, ``plot_comparison``'s files), ``tggcn_torch.data.
cross_validation`` (the video -> subject map and the file it writes) and
``tggcn_torch.utils.drawing`` (the images it draws).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import analysis as jax_analysis  # noqa: E402
from tggcn.data import cross_validation as jax_cross_validation  # noqa: E402
from tggcn.train.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from tggcn.utils import drawing as jax_drawing  # noqa: E402
from tggcn_torch import analysis  # noqa: E402
from tggcn_torch.data import cross_validation  # noqa: E402
from tggcn_torch.train.checkpoint import save_checkpoint  # noqa: E402
from tggcn_torch.utils import drawing  # noqa: E402

LOSSES = {"train_losses": [[2.5, [1.0, 1.5]], [2.0, [0.8, 1.2]], [1.7, [0.7, 1.0]]],
          "val_losses": [[2.6, [1.1, 1.5]], [2.2, [0.9, 1.3]], [2.1, [0.9, 1.2]]]}


def _run(module, argv, capsys):
    args = module.create_arg_parser().parse_args(argv)
    args.func(args)
    return capsys.readouterr().out


def _image(path):
    import matplotlib.image

    return matplotlib.image.imread(path)


def test_performance_diff_prints_what_jax_prints(tmp_path, capsys):
    first, second = tmp_path / "a.txt", tmp_path / "b.txt"
    first.write_text("video_1: 0.5\nvideo_2: 0.25\nvideo_3: 0.75\nonly_a: 0.1\n\n")
    second.write_text("video_1: 0.625\nvideo_2: 0.125\nvideo_3: 0.75\nonly_b: 0.9\n")
    for extra in ([], ["--ascending", "--top_k", "2"]):
        argv = ["performance_diff", str(first), str(second), *extra]
        want = _run(jax_analysis, argv, capsys)
        assert "only_a" in want and _run(analysis, argv, capsys) == want


def test_plot_curves_from_each_kind_of_run_dir(tmp_path, capsys):
    """A port run dir, a JAX run dir and a reference .tar run dir."""
    port_dir, jax_dir, tar_dir = (tmp_path / name for name in ("port_run", "jax_run", "tar_run"))
    save_checkpoint(str(port_dir), dict(LOSSES, epoch=3), "port_run")
    jax_save_checkpoint(str(jax_dir), dict(LOSSES, epoch=3), checkpoint_name="jax_run")
    tar_dir.mkdir()
    torch.save(dict(LOSSES, epoch=3), str(tar_dir / "tar_run.tar"))
    for run in (port_dir, jax_dir, tar_dir):
        got, want = tmp_path / f"{run.name}_port.png", tmp_path / f"{run.name}_jax.png"
        _run(analysis, ["plot_curves", str(run), "--save_file", str(got)], capsys)
        _run(jax_analysis, ["plot_curves", str(run), "--save_file", str(want)], capsys)
        np.testing.assert_array_equal(_image(got), _image(want))
    _run(analysis, ["plot_curves", str(port_dir)], capsys)
    assert (port_dir / "loss_curves.png").exists()


def test_plot_comparison_writes_the_same_files(tmp_path, capsys):
    import json

    gt = {"v1": {"0": [0, 0, 1, 1, 2], "1": [2, 2, 2, 0, 0]}, "v2": {"0": [1, 1, 1, 0, 0]},
          "v3": {"0": []}}
    ours = {"v1": {"0": [0, 1, 1, 1, 2], "1": [2, 2, 0, 0, 0]}, "v2": {"0": [1, 1, 0, 0, 0]}}
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "ours.json").write_text(json.dumps(ours))
    (tmp_path / "classes.json").write_text(json.dumps({"0": "a", "1": "b", "2": "c"}))
    for module, out in ((analysis, "port"), (jax_analysis, "jax")):
        _run(module, ["plot_comparison", str(tmp_path / "gt.json"), str(tmp_path / "ours.json"),
                      "--save_dir", str(tmp_path / out),
                      "--class_dictionary", str(tmp_path / "classes.json")], capsys)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["v1_0.png", "v1_1.png", "v2_0.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        np.testing.assert_array_equal(_image(tmp_path / "port" / name),
                                      _image(tmp_path / "jax" / name))


def test_cross_validation_map_and_file(tmp_path, capsys):
    root = tmp_path / "annotations"
    for subject, task, videos in (("Subject1", "making_cereal", ["1204142858", "1204143959"]),
                                  ("Subject3", "arranging_objects", ["0510175411"]),
                                  ("Subject3", "stacking_objects", ["0510180218"])):
        for video in videos:
            (root / f"{subject}_annotations" / task / video).mkdir(parents=True)
    (root / "Subject5_annotations" / "taking_food").mkdir(parents=True)
    (root / "Subject5_annotations" / "taking_food" / "1130144242.txt").write_text("")
    (root / "Subject5_annotations" / "taking_food" / "labeling.txt").write_text("")
    (root / "README").write_text("")
    got = cross_validation.build_video_id_to_subject_map(str(root))
    assert got == jax_cross_validation.build_video_id_to_subject_map(str(root))
    assert len(got) == 5 and got["1130144242"] == "Subject5"
    cross_validation.main([str(root), str(tmp_path / "port" / "map.txt")])
    jax_cross_validation.write_video_id_to_subject_map(got, str(tmp_path / "jax" / "map.txt"))
    assert ((tmp_path / "port" / "map.txt").read_bytes()
            == (tmp_path / "jax" / "map.txt").read_bytes())
    assert "wrote 5 entries" in capsys.readouterr().out


@pytest.mark.parametrize("dotted", [False, True])
def test_drawing_matches_jax(dotted):
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, size=(64, 80, 3)).astype(np.uint8)
    keypoints = rng.uniform(0, 60, size=(6, 2))
    keypoints[2] = np.nan
    connections = [(0, 1), (1, 2), (3, 4), (4, 5)]
    want = jax_drawing.draw_keypoints(image, keypoints, connections, dotted=dotted)
    got = drawing.draw_keypoints(image, keypoints, connections, dotted=dotted)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, image)
    boxes = np.array([[5, 5, 30, 40], [np.nan, 0, 1, 1], [40, 10, 70, 60]])
    np.testing.assert_array_equal(drawing.draw_bounding_boxes(image, boxes),
                                  jax_drawing.draw_bounding_boxes(image, boxes))


def test_drawing_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="opencv-python"):
        drawing.draw_keypoints(np.zeros((4, 4, 3), np.uint8), np.zeros((1, 2)))

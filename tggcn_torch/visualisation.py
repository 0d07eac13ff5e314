"""Segmentation bar plots (counterpart of ``tggcn/visualisation.py``;
matplotlib is imported only when a plot is drawn).

Capability match for the reference's label-bar renderer
(vhoi/visualisation.py:9-92): a ground-truth label sequence plus any number of
predicted sequences are drawn as stacked colour bars, one subplot per
sequence, with x-ticks placed inside each label run. Rebuilt here on top of
this package's own run-length encoding (utils/itertools.py rle_numpy) and
numpy broadcasting instead of per-frame fills.
"""

from typing import Dict, List, Tuple

import numpy as np

from tggcn_torch.utils.itertools import rle_numpy


def create_label_bar(label_ids: list, bar_height: int = 30,
                     bar_width: int = 5) -> np.ndarray:
    """Render a label sequence as a (bar_height, len * bar_width) image.

    Every frame's label id is stretched to a bar_width-pixel column and the
    row is broadcast to bar_height rows.
    """
    row = np.repeat(np.asarray(label_ids), bar_width)
    return np.broadcast_to(row, (bar_height, row.shape[0])).copy()


def determine_xlabels_and_xticks_positions(labels: list,
                                           bar_width: int) -> Tuple[List, List[int]]:
    """One (label, x position) pair per label run.

    The tick sits a third of the way into each run (in pixels), which is
    where the reference annotates its bars.
    """
    run_ids, starts, ends = rle_numpy(np.asarray(labels))
    ticks = (starts + (ends - starts) // 3) * bar_width
    return list(run_ids), [int(t) for t in ticks]


def plot_segmentation(target: list, *output, class_id_to_label: Dict[int, str],
                      save_file: str = None, bar_height: int = 30,
                      bar_width: int = 2000, xlabels_type: str = "label"):
    """Stacked GT + prediction label bars; saves to save_file or shows.

    xlabels_type: 'labels' annotates runs with class names, 'id' with numeric
    ids, anything else leaves the runs unannotated.
    """
    import matplotlib as mpl
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    sequences = [target, *output]
    pixels_per_frame = max(int(bar_width / len(target)), 1)
    num_classes = len(class_id_to_label)

    fig, axes = plt.subplots(len(sequences), 1, squeeze=False,
                             figsize=(num_classes, 1),
                             gridspec_kw={"wspace": 0.5, "hspace": 0.01})
    for ax, label_ids in zip(axes[:, 0], sequences):
        bar = create_label_bar(label_ids, bar_height=bar_height,
                               bar_width=pixels_per_frame).astype(np.int8)
        ax.imshow(bar, cmap=plt.get_cmap("tab20"), vmin=0, vmax=num_classes - 1)
        run_ids, ticks = determine_xlabels_and_xticks_positions(label_ids,
                                                                pixels_per_frame)
        if xlabels_type == "labels":
            annotations, fontsize = [class_id_to_label[i] for i in run_ids], "x-small"
        elif xlabels_type == "id":
            annotations, fontsize = [str(i) for i in run_ids], "small"
        else:
            annotations, fontsize = [], "small"
        ax.set_xticks(ticks)
        ax.set_xticklabels(annotations, fontsize=fontsize,
                           horizontalalignment="left")
        ax.set_yticklabels([])
        ax.tick_params(axis="both", which="both", length=0)

    if save_file is not None:
        fig.savefig(save_file, bbox_inches="tight", pad_inches=0,
                    transparent=True)
    else:
        plt.show()
    plt.close(fig)

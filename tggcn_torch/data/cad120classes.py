"""CAD-120 annotation schema + unpickling shim.

The CAD-120 preprocessed annotations (cad120data.pickle) store instances of
``vhoi.cad120classes.CAD120Video`` / ``CAD120VideoSegment`` (reference
vhoi/cad120classes.py:4-43). The classes below carry the same attribute
surface so the pickle can be loaded without the reference installed;
``load_cad120_pickle`` remaps the reference's module path, and that of the
JAX package's copy (``tggcn/data/cad120classes.py``), onto this module.
"""

import pickle
from collections import defaultdict


class CAD120VideoSegment:
    def __init__(self):
        self.skeleton_features = None
        self.skeleton_object_features = {}       # Object ID -> features
        self.skeleton_temporal_features = None
        self.object_features = {}                # Object ID -> features
        self.object_object_features = {}         # (Object 1 ID, Object 2 ID) -> features
        self.object_temporal_features = {}       # Object ID -> features
        self.subactivity = None
        self.next_subactivity = None
        self.object_affordance = {}              # Object ID -> affordance
        self.next_object_affordance = {}         # Object ID -> affordance
        self.subactivity_name = None
        self.object_affordance_name = {}         # Object ID -> affordance name
        self.object_type = {}                    # Object ID -> type (e.g. mug, book)
        self.start_frame = None
        self.end_frame = None


class CAD120Video:
    def __init__(self):
        self._video_segments = defaultdict(CAD120VideoSegment)

    def __getitem__(self, item):
        return self._video_segments[item]

    def __iter__(self):
        return iter(self._video_segments)

    def __len__(self):
        return len(self._video_segments)

    def from_dict_to_list(self):
        self._video_segments = sorted(list(self._video_segments.items()))
        self._video_segments = [segment for _, segment in self._video_segments]

    def update_next_labels(self):
        for segment, next_segment in zip(self._video_segments[:-1], self._video_segments[1:]):
            segment.next_subactivity = next_segment.subactivity
            segment.next_object_affordance = dict(next_segment.object_affordance)


class _Cad120Unpickler(pickle.Unpickler):
    # The reference's pickles name vhoi's classes; those the JAX package's
    # synthetic datasets write name its own.
    _remap = {(module, name): cls
              for module in ("vhoi.cad120classes", "tggcn.data.cad120classes")
              for name, cls in (("CAD120Video", CAD120Video),
                                ("CAD120VideoSegment", CAD120VideoSegment))}

    def find_class(self, module, name):
        if (module, name) in self._remap:
            return self._remap[(module, name)]
        return super().find_class(module, name)


def load_cad120_pickle(path: str):
    with open(path, mode="rb") as f:
        return _Cad120Unpickler(f).load()

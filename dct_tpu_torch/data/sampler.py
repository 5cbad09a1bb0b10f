"""Patient-grouped sampling (``dct_tpu/data/sampler.py``): one variable-size
batch of indices per patient, so a val-time 3D dice covers a whole volume.
The trainers pad volumes to a common length instead
(``data/pipeline.py:PatientBuckets``); this is the host-side grouping."""
from __future__ import annotations

import random
import re
from typing import Dict, List

from .dataset import MedicalImageDataset


class PatientSampler:
    def __init__(self, dataset: MedicalImageDataset, grp_regex: str,
                 shuffle: bool = False, quite: bool = False) -> None:
        self.grp_regex = grp_regex
        self.shuffle = shuffle
        pattern = re.compile(grp_regex)
        stems = dataset.filenames
        patients = []
        for stem in stems:
            m = pattern.match(stem)
            assert m, f"{stem!r} does not match {grp_regex!r}"
            patients.append(m.group(1))
        unique = sorted(set(patients))
        assert len(unique) < len(stems), "regex groups nothing"
        if not quite:
            print(f"Grouping using {grp_regex}: {len(unique)} unique patients "
                  f"out of {len(stems)} images")
        self.idx_map: Dict[str, List[int]] = {p: [] for p in unique}
        for i, p in enumerate(patients):
            self.idx_map[p].append(i)
        assert sum(len(v) for v in self.idx_map.values()) == len(stems)

    def __len__(self) -> int:
        return len(self.idx_map)

    def __iter__(self):
        values = list(self.idx_map.values())
        if self.shuffle:
            values = random.sample(values, len(values))
        return iter(values)

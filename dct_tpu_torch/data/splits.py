"""Semi-supervised split builders: labeled partitions, unlabeled set, val set
(``dct_tpu/data/splits.py``).

Host code only. The global ``np.random`` calls run in dct_tpu's order
(permutation, then choice) under the experiment seed, so the partitions
equal dct_tpu's run for run.
"""
from __future__ import annotations

import re
from functools import reduce
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .dataset import MedicalImageDataset


def extract_patients(dataset: MedicalImageDataset, patient_ids: Sequence[str],
                     id_format: str = "patient%.3d") -> MedicalImageDataset:
    """Subset by patient-number patterns."""
    patterns = [id_format % int(i) for i in patient_ids]
    return dataset.filter_by_patterns(patterns)


def _partition_patients(lab_ids: Tuple[int, int], partition_overlap: float,
                        n_models: int) -> List[np.ndarray]:
    """Shared and exclusive labeled patients per model (``np.random``:
    permutation, then choice)."""
    rd_idx = np.random.permutation(range(*lab_ids))
    overlap_idx = np.random.choice(
        rd_idx, size=int(float(partition_overlap) * len(range(*lab_ids))),
        replace=False)
    exclusive_idx = [x for x in rd_idx if x not in overlap_idx]
    per_model = int(len(exclusive_idx) / n_models)
    excl = [exclusive_idx[i * per_model:(i + 1) * per_model] for i in range(n_models)]
    return [np.hstack((overlap_idx, np.array(excl[i], dtype=overlap_idx.dtype)))
            for i in range(n_models)]


def _ratio_split_datasets(config: Dict, root_key_default: str, id_format: str):
    """ACDC and Spleen: patients 1..100, a ratio → labeled / unlabeled."""
    ds_cfg = dict(config["Dataset"])
    partition_ratio = config["Lab_Partitions"]["partition_sets"]
    lab_ids = (1, int(100 * partition_ratio + 1))
    unlab_ids = (int(100 * partition_ratio + 1), 101)
    n_models = int(config["Lab_Partitions"]["num_models"])
    overlap = config["Lab_Partitions"]["partition_overlap"]

    root = ds_cfg.pop("root_dir", root_key_default)
    ds_cfg.pop("name", None)
    train_set = MedicalImageDataset(root, "train", **ds_cfg)
    val_set = MedicalImageDataset(root, "val", **{**ds_cfg, "quite": True})

    lab_partitions = _partition_patients(lab_ids, overlap, n_models)
    labeled_sets = [extract_patients(train_set, [str(int(x)) for x in part], id_format)
                    for part in lab_partitions]
    unlab_set = extract_patients(train_set, [str(x) for x in range(*unlab_ids)], id_format)
    print("labeled_image_number:", len(range(*lab_ids)),
          "unlab_image_number:", len(range(*unlab_ids)))
    print(f"{len(lab_partitions)} datasets with overlap labeled image number",
          len(reduce(lambda x, y: x & y, [set(p.tolist()) for p in lab_partitions])))
    return labeled_sets, unlab_set, val_set


def get_acdc_split_datasets(config: Dict):
    """K labeled subsets + unlabeled + val for ACDC."""
    return _ratio_split_datasets(config, "dataset/ACDC-all", "patient%.3d")


def get_spleen_split_datasets(config: Dict):
    """Spleen: 'Patient_%02d' ids."""
    return _ratio_split_datasets(config, "dataset/Spleen", "Patient_%.2d")


def get_gmc_split_datasets(config: Dict):
    """Spinal-cord GM challenge: site-based val split, then the labeled
    experiments partitioned (``np.random.choice`` of the shared ones)."""
    ds_cfg = dict(config["Dataset"])
    root = ds_cfg.pop("root_dir")
    ds_cfg.pop("name", None)
    train_all = MedicalImageDataset(root, "train", **ds_cfg)
    unlab_set = MedicalImageDataset(root, "unlabeled", **{**ds_cfg, "quite": True})

    val_set = train_all.filter_by_patterns([r"site3", r"site4"])
    train_set = train_all.filter_by_patterns([r"site1"])

    u_pattern = re.compile(r"site\d-sc\d\d")
    u_samples = sorted({u_pattern.findall(x)[0] for x in train_set.filenames})
    n_models = int(config["Lab_Partitions"]["num_models"])
    overlap = float(config["Lab_Partitions"]["partition_overlap"])
    common = list(np.random.choice(u_samples, int(len(u_samples) * overlap),
                                   replace=False))
    exclusive = [x for x in u_samples if x not in common]
    per_loader = [list(common) + exclusive[i::n_models] for i in range(n_models)]
    labeled_sets = [train_set.filter_by_patterns(p) for p in per_loader]
    print(f"{len(labeled_sets)} GM datasets; overlap experiments:",
          len(reduce(lambda x, y: x & y, [set(p) for p in per_loader])))
    return labeled_sets, unlab_set, val_set


def get_prostate_split_datasets(config: Dict):
    """PROSTATE (``Case%.2d_0_%.2d`` stems): the ACDC ratio scheme
    (permutation, then choice) over the Case ids present in the tree."""
    ds_cfg = dict(config["Dataset"])
    ratio = float(config["Lab_Partitions"]["partition_sets"])
    n_models = int(config["Lab_Partitions"]["num_models"])
    overlap = float(config["Lab_Partitions"]["partition_overlap"])
    root = ds_cfg.pop("root_dir", "dataset/PROSTATE")
    ds_cfg.pop("name", None)
    train_set = MedicalImageDataset(root, "train", **ds_cfg)
    val_set = MedicalImageDataset(root, "val", **{**ds_cfg, "quite": True})

    case_pat = re.compile(r"(Case\d+)_")
    cases = sorted({case_pat.match(f).group(1) for f in train_set.filenames})
    n_lab = max(1, int(len(cases) * ratio))
    lab_cases, unlab_cases = cases[:n_lab], cases[n_lab:]

    rd_idx = np.random.permutation(lab_cases)
    overlap_idx = np.random.choice(rd_idx, size=int(overlap * len(lab_cases)),
                                   replace=False)
    exclusive = [x for x in rd_idx if x not in overlap_idx]
    per_model = int(len(exclusive) / n_models) if n_models else 0
    parts = [list(overlap_idx) + exclusive[i * per_model:(i + 1) * per_model]
             for i in range(n_models)]
    labeled_sets = [train_set.filter_by_patterns(sorted(p)) for p in parts]
    unlab_set = train_set.filter_by_patterns(sorted(unlab_cases))
    print(f"labeled cases: {len(lab_cases)}  unlabeled cases: {len(unlab_cases)}")
    print(f"{n_models} datasets with overlap labeled case number",
          len(reduce(lambda x, y: x & y, [set(p) for p in parts])))
    return labeled_sets, unlab_set, val_set


SPLIT_BUILDERS = {
    "acdc": get_acdc_split_datasets,
    "spleen": get_spleen_split_datasets,
    "gm": get_gmc_split_datasets,
    "prostate": get_prostate_split_datasets,
}


def get_dataset_split(config: Dict, name: str = "acdc"):
    return SPLIT_BUILDERS[name.lower()](config)

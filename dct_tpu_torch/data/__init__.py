"""Device-resident data path and on-device augmentation: datasets, splits,
samplers, batchers and the warps (``dct_tpu/data``)."""
from .cityscapes import CityscapesDataset, get_cityscapes_split  # noqa: F401
from .dataset import ConcatDataset, MedicalImageDataset, parse_transform_size  # noqa: F401
from .metainfo import classSizeCalulator, get_metainfo_generator, getImage_GT  # noqa: F401
from .sampler import PatientSampler  # noqa: F401
from .splits import (  # noqa: F401
    extract_patients,
    get_acdc_split_datasets,
    get_dataset_split,
)
from .augment import augment_batch, sample_aug_thetas  # noqa: F401
from .pipeline import DeviceDataset, EpochBatcher, InfiniteBatcher, PatientBuckets  # noqa: F401

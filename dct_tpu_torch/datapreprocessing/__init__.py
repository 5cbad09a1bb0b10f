"""Offline preprocessing: the nii → PNG slicers and the Cityscapes tools
(``dct_tpu/datapreprocessing``)."""
from .slicers import (center_crop, norm_arr, resize_by_resolution,  # noqa: F401
                      save_spin_slices, save_volume_slices)

"""Reports across runs (``dct_tpu/postprocessing``)."""

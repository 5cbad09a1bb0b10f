"""Helpers: one-hot and dice (``general``), the flax weight bridge (``convert``)."""

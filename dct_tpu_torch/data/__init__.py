"""Device-resident data path and on-device augmentation."""

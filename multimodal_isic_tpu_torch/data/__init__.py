"""Data: synthetic datasets, manifests, decoding, records and loaders
(host), preprocessing and augmentation (torch)."""

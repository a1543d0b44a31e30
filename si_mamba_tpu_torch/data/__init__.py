"""Data: batched augmentations (``transforms``)."""

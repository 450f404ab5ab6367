"""Data layer: raw readers, the dataset container, the eval transform."""

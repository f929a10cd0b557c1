"""Synthetic batches, the TFRecord schema and the host input pipeline."""

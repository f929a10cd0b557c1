"""Synthetic batches, the TFRecord schema and the host input pipeline; the
WOMD rasterizer and the offline preprocessor that writes the records."""

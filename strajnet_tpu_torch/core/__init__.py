"""Bilinear sampling with challenge-parity semantics, world-to-grid
transforms, and the C library's float32 sine and cosine."""

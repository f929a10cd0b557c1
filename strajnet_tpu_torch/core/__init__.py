"""Bilinear sampling with challenge-parity semantics."""

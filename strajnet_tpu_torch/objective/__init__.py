"""Waypoint slicing and output activations."""

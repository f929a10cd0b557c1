"""Batch inference and the challenge submission writer."""

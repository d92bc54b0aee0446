"""Utilities: image-quality metrics."""

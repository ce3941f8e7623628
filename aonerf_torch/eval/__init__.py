"""Evaluation: tiled image rendering and image metrics."""

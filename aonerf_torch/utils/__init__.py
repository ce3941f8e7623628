"""Utilities: the flax-to-torch weight bridge."""

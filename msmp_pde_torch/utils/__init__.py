"""Utilities: weights carried across from the flax param tree."""

"""Tensor ops: color transforms, resizes, erosion, pyramids, Grams, sampling."""

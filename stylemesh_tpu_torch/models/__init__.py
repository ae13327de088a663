"""Texture, VGG trunk, losses and the training pipeline."""

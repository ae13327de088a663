"""Batch schema and synthetic scenes (numpy host code)."""

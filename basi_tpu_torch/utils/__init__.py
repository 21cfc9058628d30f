"""Metric logging and checkpoints of training."""

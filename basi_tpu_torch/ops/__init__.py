"""Tensor ops of the port: resize and mask NMS / slot selection."""

"""Evaluation: mask IoU matching, mask AP/AR and the saliency metrics."""

"""Inference, evaluation and training engines."""

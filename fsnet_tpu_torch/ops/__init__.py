"""Tensor ops of the port; ``conv3x3`` holds the decoder's Hopper kernel."""

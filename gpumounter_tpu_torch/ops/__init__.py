"""Attention ops: hand-written Hopper kernels beside their plain versions."""

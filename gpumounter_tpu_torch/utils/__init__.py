"""Logging, named locks and phase timing for the control plane."""

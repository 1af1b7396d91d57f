"""Logging, named locks, phase timing, auth and the lazy grpc import for the
control plane."""

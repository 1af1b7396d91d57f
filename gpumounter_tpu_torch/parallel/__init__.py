"""Training steps of the probe (one device so far)."""

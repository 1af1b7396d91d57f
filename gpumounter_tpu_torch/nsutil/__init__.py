"""Device-node operations inside a container's mount namespace."""

"""In-process stand-ins for a cluster, for tests and dry runs."""

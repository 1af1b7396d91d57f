"""The Kubernetes layer: pod JSON, the client surface, an in-memory fake."""

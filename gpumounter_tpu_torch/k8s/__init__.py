"""The Kubernetes layer: pod JSON, the client surface, the REST client and an
in-memory fake."""

"""The master: the HTTP API and its worker registry."""

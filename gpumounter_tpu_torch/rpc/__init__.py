"""The master <-> worker contract and its transport: the proto3 codec, the
messages, the worker's gRPC client with its retries and breaker, and the gRPC
health service."""

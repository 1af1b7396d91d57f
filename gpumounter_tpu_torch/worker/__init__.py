"""The worker: mount mechanics, the add/remove flows of one node, their gRPC
server, and the daemon."""

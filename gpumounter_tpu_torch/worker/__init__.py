"""The worker: mount mechanics, the add/remove flows of one node, their gRPC
server, the mount ledger with its replay, the slave reaper, and the daemon."""

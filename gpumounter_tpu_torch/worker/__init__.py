"""The worker: mount mechanics and the add/remove flows of one node."""

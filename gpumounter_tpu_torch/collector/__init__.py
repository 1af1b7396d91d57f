"""The collector: the node's GPU inventory and which pod holds which GPU."""

"""The master <-> worker contract, without the wire (it comes with the
transport)."""

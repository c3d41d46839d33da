"""Fault-tolerance primitives of the port."""

"""Example programs built on the port."""

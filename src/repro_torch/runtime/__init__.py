"""Serve steps of the port."""

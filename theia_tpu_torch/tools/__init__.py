"""Measurement scripts of the port; nothing in the package imports them."""

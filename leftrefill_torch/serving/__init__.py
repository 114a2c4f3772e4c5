"""The serving entry points of the port."""

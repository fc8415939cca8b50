"""Helpers shared by the port's modules."""

"""Helpers shared by the port's packages."""

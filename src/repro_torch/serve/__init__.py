"""Serving helpers shared by the port's servers."""

"""Serving helpers shared by the port's servers (`slots`) and the LM
engine (`engine`)."""

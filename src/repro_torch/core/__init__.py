"""Quantized-net definitions and the synthetic digit dataset."""

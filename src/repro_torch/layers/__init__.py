"""Normalization, weight access, embedding and the Mamba2 mixer of the
port's LM stack."""

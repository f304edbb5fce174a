"""Atomic training checkpoints of the port (`ckpt`)."""

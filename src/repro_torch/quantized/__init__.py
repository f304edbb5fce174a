"""Post-training int8 weight quantization of LM checkpoints."""

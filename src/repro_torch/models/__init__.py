"""The LM stack's models: `base` (configs, abstract params), `mamba` (the
Mamba2 LM), `transformer` (the dense decoder), `api` (family dispatch),
`convert` (weights carried in from numpy)."""

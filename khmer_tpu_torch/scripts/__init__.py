"""Command-line entry points: python -m khmer_tpu_torch.scripts.<name>."""

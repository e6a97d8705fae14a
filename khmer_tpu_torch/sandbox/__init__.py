"""Sandbox scripts of khmer_tpu (sandbox/*.py) on the port, each run as
``python -m khmer_tpu_torch.sandbox.<name>`` or called as
``main(argv=None, device=None)``."""

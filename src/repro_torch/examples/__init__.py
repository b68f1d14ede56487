"""Walkthroughs of the port, run with `python -m repro_torch.examples.<name>`."""

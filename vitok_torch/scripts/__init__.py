"""Command-line entry points of the port (``python -m vitok_torch.scripts.<name>``)."""

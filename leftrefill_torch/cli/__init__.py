"""Command-line entry points of the port (``python -m leftrefill_torch.cli.train``)."""

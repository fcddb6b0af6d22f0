"""The suites: registry of configurations and the CLI (``python -m blindno_torch.suites.run``)."""

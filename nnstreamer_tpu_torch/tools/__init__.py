"""Command-line tools of the port: ``lint``, ``doctor``, ``inspect``, ``parse``."""

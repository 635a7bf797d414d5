"""Command-line entry points (``serve``)."""

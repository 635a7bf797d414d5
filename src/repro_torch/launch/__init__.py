"""Command-line entry points (``serve``, ``train``)."""

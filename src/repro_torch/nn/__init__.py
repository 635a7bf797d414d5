"""Parameter specs: the single declaration parameters are built from."""

"""Scene export of a finished run."""

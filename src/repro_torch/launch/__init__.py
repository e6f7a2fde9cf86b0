"""Launchers: the trainer (``train``) and the serving loop (``serve``)."""

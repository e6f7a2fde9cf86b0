"""Launchers: the trainer (serving follows in a later slice)."""

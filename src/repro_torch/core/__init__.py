"""The comm-schedule IR shared by the runtime (the numpy simulator and the
experiment engine are not ported yet)."""

"""The port's share of ``repro.core``: the comm-schedule IR of the runtime
(``schedule``) and the measurement seams (``addest``, ``codec``,
``timeline``, and of ``flops`` the part that ``timeline.measure`` needs).
The numpy simulator and the experiment engine are not ported yet."""

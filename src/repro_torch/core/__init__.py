"""The port's share of ``repro.core``: the comm-schedule IR of the runtime
and its lowering onto the discrete-event engine (``schedule``, ``events``),
the what-if simulator (``simulator``, with ``transport``, ``network_model``,
``fabric``, ``faults``), the paper's workload profiles (``cnn_profiles``)
and the measurement seams (``addest``, ``codec``, ``timeline``, and of
``flops`` the part that ``timeline.measure`` needs).  The experiment engine
and ``whatif`` are not ported yet."""

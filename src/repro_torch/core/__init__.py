"""The port's copy of ``repro.core``: the comm-schedule IR of the runtime
and its lowering onto the discrete-event engine (``schedule``, ``events``),
the what-if simulator (``simulator``, with ``transport``, ``network_model``,
``fabric``, ``faults``), the paper's workload profiles (``cnn_profiles``),
the analytic FLOP model (``flops``), the figure builders and the H100
what-if (``whatif``, over the experiment engine ``repro_torch.experiments``)
and the measurement seams (``addest``, ``codec``, ``timeline``)."""

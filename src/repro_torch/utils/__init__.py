"""Small helpers shared by the port: parameter-tree walking and the tracer."""

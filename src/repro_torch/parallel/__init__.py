"""The bucketed / hierarchical / compressed gradient sync and its collectives."""

"""The port's benchmark: harness (``pb``), plain reference (``reference``),
and the data files of its configurations, traffic, metrics and limits."""

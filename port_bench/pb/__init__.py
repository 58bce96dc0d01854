"""The general harness: it finds a cell's configuration, traffic, metrics,
reference and limits by the names in BENCHMARK.json."""

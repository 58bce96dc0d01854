"""Plain float64 references of the benchmark's configurations.  Nothing here
imports the program under test."""

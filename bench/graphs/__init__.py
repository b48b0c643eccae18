"""Graph generators of the benchmark's configurations."""

"""Tools that run the benchmark many times; none is run by a cell."""

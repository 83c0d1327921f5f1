"""Tools that set and check the benchmark's limits on the card."""

"""Operation and byte counts of the benchmark, and the card's peaks."""

"""TDT greedy decode."""

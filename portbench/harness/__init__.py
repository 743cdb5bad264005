"""The general harness: finds cells, configurations, traffic, metrics and limits by name, makes the
seeded weights, times the window, traces it and prints the result line."""

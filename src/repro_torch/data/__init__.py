"""The synthetic training data and its prefetcher."""

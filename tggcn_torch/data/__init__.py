"""Batch adapters of the port: the 2G-GCN feeder and fetcher."""

"""Data of the port: dataset loading and assembly, synthetic datasets, and
the 2G-GCN batch feeder and fetcher."""

"""Device plumbing of the PyTorch port: fetches and strategy tables."""

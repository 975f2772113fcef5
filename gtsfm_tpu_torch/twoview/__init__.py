"""Two-view estimation: batched two-view bundle adjustment."""

"""Image IO, colour conversion and filesystem helpers."""
